"""BoW inverted-file keyframe database.

Rebuild of KeyFrameDatabase (reference src/KeyFrameDatabase.cc) as
airdos_tpu/slam/keyframe_db.py keeps it: word -> set of keyframe ids,
filled as keyframes leave the mapping pass, emptied as they are culled.
Host-side (tiny sparse integer work).  Candidate detection for loop
closing and relocalization is not ported yet (ROADMAP port queue:
relocalization and loop closing).
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

    def detect_loop_candidates(self, kf: KeyFrame,
                               min_score: float) -> List[int]:
        raise NotImplementedError(
            "loop candidates are not ported yet (ROADMAP port queue: "
            "relocalization and loop closing)")

    def detect_reloc_candidates(self, bow: Dict[int, float]) -> List[int]:
        raise NotImplementedError(
            "relocalization candidates are not ported yet (ROADMAP port "
            "queue: relocalization and loop closing)")
