"""BoW inverted-file keyframe database.

Rebuild of KeyFrameDatabase (reference src/KeyFrameDatabase.cc) as
airdos_tpu/slam/keyframe_db.py keeps it: word -> set of keyframe ids,
filled as keyframes leave the mapping pass, emptied as they are culled;
loop-candidate detection with shared-word counting excluding covisible
KFs, the 0.8*maxCommonWords cut, covisibility-group score accumulation
and the 0.75*bestAccScore cut (reference KeyFrameDatabase.cc:76-197);
relocalization candidates without the covisibility exclusion (199-310).
Host-side (tiny sparse integer work).  The loop detector keeps groups
strictly above the cut, the relocalization detector at or above it, as
airdos_tpu does.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set

from airdos_tpu_torch.bow.vocabulary import Vocabulary
from airdos_tpu_torch.slam.map import KeyFrame, SlamMap


class KeyFrameDatabase:
    def __init__(self, vocabulary: Vocabulary, slam_map: SlamMap):
        self.voc = vocabulary
        self.map = slam_map
        # word -> set of KF ids: O(1) erase
        self.inverted: Dict[int, Set[int]] = defaultdict(set)

    def ensure_bow(self, kf: KeyFrame):
        if kf.bow is None:
            bow, wids, fnodes = self.voc.transform(kf.desc32, kf.valid)
            kf.bow = bow
            kf.word_ids = wids
            kf.feat_nodes = fnodes

    def add(self, kf: KeyFrame):
        if getattr(kf, "_in_db", False):
            return
        kf._in_db = True
        self.ensure_bow(kf)
        for w in kf.bow:
            self.inverted[w].add(kf.id)

    def erase(self, kf: KeyFrame):
        if kf.bow is None:
            return
        for w in kf.bow:
            s = self.inverted.get(w)
            if s is not None:
                s.discard(kf.id)
        kf._in_db = False

    def clear(self):
        self.inverted = defaultdict(set)
        for kf in self.map.kfs.values():
            kf._in_db = False

    def _shared_word_counts(self, bow: Dict[int, float],
                            exclude: Set[int]) -> Dict[int, int]:
        counts: Dict[int, int] = defaultdict(int)
        for w in bow:
            for kid in self.inverted.get(w, ()):
                if kid not in exclude:
                    kf = self.map.kfs.get(kid)
                    if kf is not None and not kf.bad:
                        counts[kid] += 1
        return counts

    def _candidates(self, bow: Dict[int, float], exclude: Set[int],
                    min_score: float, strict: bool) -> List[int]:
        """Keyframes sharing > 0.8 x the most shared words and scoring >=
        min_score, each replaced by the best of its covisibility group
        (top-10 covisibles), whose accumulated score passes 0.75 x the
        best group's: strictly above it (strict) or at or above it."""
        counts = self._shared_word_counts(bow, exclude)
        if not counts:
            return []
        min_common = 0.8 * max(counts.values())
        scored = {}
        for kid, c in counts.items():
            if c <= min_common:
                continue
            other = self.map.kfs[kid]
            self.ensure_bow(other)
            s = Vocabulary.score(bow, other.bow)
            if s >= min_score:
                scored[kid] = s
        if not scored:
            return []
        acc = []
        for kid, s in scored.items():
            best_in_group, acc_score, best_s = kid, 0.0, s
            for gid in [kid] + self.map.kfs[kid].best_covisible(10):
                gs = scored.get(gid)
                if gs is not None:
                    acc_score += gs
                    if gs > best_s:
                        best_s, best_in_group = gs, gid
            acc.append((best_in_group, acc_score))
        th = 0.75 * max(a for _, a in acc)
        out, seen = [], set()
        for kid, a in acc:
            if (a > th if strict else a >= th) and kid not in seen:
                seen.add(kid)
                out.append(kid)
        return out

    def detect_loop_candidates(self, kf: KeyFrame,
                               min_score: float) -> List[int]:
        """Loop candidates of kf: its covisible keyframes excluded, scores
        at least min_score, groups strictly above the cut."""
        self.ensure_bow(kf)
        return self._candidates(kf.bow, set(kf.covis) | {kf.id}, min_score,
                                strict=True)

    def detect_reloc_candidates(self, bow: Dict[int, float]) -> List[int]:
        """Relocalization candidates of a frame's BoW vector: no exclusion,
        no score floor, groups at or above the cut."""
        return self._candidates(bow, set(), float("-inf"), strict=False)
