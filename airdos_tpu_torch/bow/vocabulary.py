"""Bag-of-words vocabulary: array-flattened k-ary tree.

Rebuild of DBoW2's TemplatedVocabulary (reference Thirdparty/DBoW2) as
airdos_tpu/bow/vocabulary.py holds it: a k-branching, L-level tree of
binary ORB descriptors with TF-IDF weights and L1 scoring, kept as flat
arrays.  The descent of a whole frame's descriptors runs batched on the
vocabulary's torch device (plain torch; its Hopper kernel is ROADMAP
Hopper queue item 6).  Training (binary k-medoids by bit majority) is
host numpy and gives the same tree as airdos_tpu from the same
descriptors and seed.

Loading the DBoW2 text and binary files is not ported yet (ROADMAP port
queue: relocalization and loop closing).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from airdos_tpu_torch.convert import desc_to_tensor, resolve_device
from airdos_tpu_torch.ops.hamming_kernels import _popcount32


def _pack_u32(desc_u8: np.ndarray) -> np.ndarray:
    d = desc_u8.astype(np.uint32).reshape(-1, 8, 4)
    return d[:, :, 0] | (d[:, :, 1] << 8) | (d[:, :, 2] << 16) | (d[:, :, 3] << 24)


@dataclasses.dataclass
class Vocabulary:
    """Flattened tree.  Level 0 is the root (index 0)."""
    k: int                        # branching factor
    depth: int                    # number of levels below root
    node_desc32: np.ndarray       # [n_nodes, 8] uint32
    children: np.ndarray          # [n_nodes, k] int32 (-1 = none)
    word_id: np.ndarray           # [n_nodes] int32 (-1 unless leaf)
    weights: np.ndarray           # [n_words] float32 idf weights
    n_words: int
    # FeatureVector grouping: levels up FROM THE LEAVES (DBoW2
    # getParentNode(wid, levelsup) semantics; see airdos_tpu's Vocabulary)
    feature_level: int = 4
    # torch device of the descent
    device: Any = dataclasses.field(default="cuda", compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._group_of_node = self._build_group_table()
        self._tables = None

    def _build_group_table(self) -> np.ndarray:
        """Per-node FeatureVector group: the ancestor ``feature_level``
        steps above (stopping at the root)."""
        n = len(self.word_id)
        parent = np.zeros(n, np.int32)
        pids, slots = np.nonzero(self.children >= 0)
        parent[self.children[pids, slots]] = pids
        group = np.arange(n, dtype=np.int32)
        for _ in range(max(0, int(self.feature_level))):
            group = parent[group]          # parent[0] == 0: stop at root
        return group

    # -------------------------------------------------------------- device
    def _device_tables(self):
        """The tree on the device, uploaded once: children, node words
        (uint32 values in int64), word ids, groups."""
        if self._tables is None:
            self._tables = tuple(
                torch.from_numpy(x.astype(np.int64)).to(self.device)
                for x in (self.children, self.node_desc32, self.word_id,
                          self._group_of_node))
        return self._tables

    def _transform_device(self, desc32: torch.Tensor):
        """desc32 [N, 8] int32 bit views -> (word ids [N], node at the
        feature level [N]).  Batched tree descent: at each level gather the
        k children's descriptors and take the Hamming argmin (first index
        on ties, like jnp.argmin)."""
        children, node_desc, word_id, group_of = self._device_tables()
        N = desc32.shape[0]
        d64 = desc32.to(torch.int64) & 0xFFFFFFFF
        cur = torch.zeros(N, dtype=torch.int64, device=desc32.device)
        for _ in range(self.depth):
            ch = children[cur]                          # [N, k]
            cd = node_desc[torch.clamp(ch, min=0)]      # [N, k, 8]
            dist = _popcount32(cd ^ d64[:, None, :]).sum(-1)
            dist = torch.where(ch >= 0, dist, torch.full_like(dist, 1 << 20))
            best = torch.argmin(dist, dim=-1)
            nxt = torch.gather(ch, 1, best[:, None])[:, 0]
            # stop at leaves (stay put when no children)
            cur = torch.where((ch >= 0).any(dim=-1), nxt, cur)
        return word_id[cur], group_of[cur]

    # ---------------------------------------------------------------- api
    def transform(self, desc32: np.ndarray, valid: Optional[np.ndarray] = None
                  ) -> Tuple[Dict[int, float], np.ndarray, np.ndarray]:
        """Returns (bow_vector word->weight L1-normalized, word ids [N],
        feature-level node ids [N]); invalid slots get word -1."""
        wids, fnodes = self._transform_device(desc_to_tensor(desc32,
                                                             self.device))
        both = torch.stack([wids, fnodes]).cpu().numpy().astype(np.int32)
        wids, fnodes = both[0], both[1]
        if valid is not None:
            wids = np.where(valid, wids, -1)
            fnodes = np.where(valid, fnodes, -1)
        bow: Dict[int, float] = {}
        for w in wids:
            if w >= 0 and self.weights[w] > 0:
                bow[int(w)] = bow.get(int(w), 0.0) + float(self.weights[w])
        total = sum(bow.values())
        if total > 0:
            bow = {w: v / total for w, v in bow.items()}
        return bow, wids, fnodes

    @staticmethod
    def score(bow1: Dict[int, float], bow2: Dict[int, float]) -> float:
        """DBoW2 L1 score in [0, 1] (ScoringObject.cc L1Scoring)."""
        s = 0.0
        for w, v1 in bow1.items():
            v2 = bow2.get(w)
            if v2 is not None:
                s += abs(v1) + abs(v2) - abs(v1 - v2)
        return 0.5 * s

    # ------------------------------------------------------------ save/load
    def save_npz(self, path: str | Path):
        np.savez_compressed(path, k=self.k, depth=self.depth,
                            node_desc32=self.node_desc32, children=self.children,
                            word_id=self.word_id, weights=self.weights,
                            n_words=self.n_words,
                            feature_level=self.feature_level)

    @classmethod
    def load_npz(cls, path: str | Path, device="cuda") -> "Vocabulary":
        z = np.load(path)
        return cls(k=int(z["k"]), depth=int(z["depth"]),
                   node_desc32=z["node_desc32"], children=z["children"],
                   word_id=z["word_id"], weights=z["weights"],
                   n_words=int(z["n_words"]),
                   feature_level=int(z["feature_level"])
                   if "feature_level" in z.files else 4, device=device)


def train_vocabulary(descriptors_u8: np.ndarray, k: int = 10, depth: int = 4,
                     seed: int = 0, max_iters: int = 8,
                     device="cuda") -> Vocabulary:
    """Hierarchical binary k-means (bit-majority medoids), like DBoW2's
    create().  descriptors_u8: [N, 32] uint8 training set.  Host numpy,
    the same steps and random draws as airdos_tpu; the idf weights come
    from the descent on `device`."""
    rng = np.random.default_rng(seed)
    desc32 = _pack_u32(descriptors_u8)
    bits = np.unpackbits(descriptors_u8, axis=1).astype(np.float32)  # [N, 256]

    nodes_desc = [np.zeros(8, np.uint32)]   # root placeholder
    children: list = [[]]
    node_items = {0: np.arange(len(desc32))}
    leaves = []

    frontier = [0]
    for lvl in range(depth):
        next_frontier = []
        for nid in frontier:
            items = node_items[nid]
            if len(items) == 0:
                continue
            kk = min(k, len(items))
            # init: random distinct descriptors
            sel = rng.choice(len(items), kk, replace=False)
            centers = bits[items[sel]].copy()
            assign = None
            for _ in range(max_iters):
                d = np.abs(bits[items][:, None, :] - centers[None, :, :]).sum(-1)
                new_assign = d.argmin(1)
                if assign is not None and (new_assign == assign).all():
                    break
                assign = new_assign
                for c in range(kk):
                    members = items[assign == c]
                    if len(members):
                        centers[c] = (bits[members].mean(0) > 0.5).astype(np.float32)
            # create child nodes with majority-bit descriptors
            ch_ids = []
            for c in range(kk):
                members = items[assign == c]
                if len(members) == 0:
                    continue
                cid = len(nodes_desc)
                cd_bits = (bits[members].mean(0) > 0.5).astype(np.uint8)
                nodes_desc.append(_pack_u32(np.packbits(cd_bits)[None])[0])
                children.append([])
                node_items[cid] = members
                ch_ids.append(cid)
                if lvl + 1 == depth:
                    leaves.append(cid)
                else:
                    next_frontier.append(cid)
            children[nid] = ch_ids
        frontier = next_frontier
    # any frontier nodes that never split further are leaves too
    for nid in frontier:
        if not children[nid]:
            leaves.append(nid)

    n_nodes = len(nodes_desc)
    node_desc32 = np.stack(nodes_desc).astype(np.uint32)
    ch_arr = np.full((n_nodes, k), -1, np.int32)
    for nid, ch in enumerate(children):
        ch_arr[nid, :len(ch)] = ch
    word_id = np.full(n_nodes, -1, np.int32)
    for w, nid in enumerate(sorted(set(leaves))):
        word_id[nid] = w
    n_words = int((word_id >= 0).sum())

    # idf weights from the training set, over pseudo-documents of 500
    # features; full-depth words group ~4 levels below the root
    counts = np.zeros(n_words, np.float64)
    n_docs = max(1, len(desc32) // 500)
    doc_ids = np.arange(len(desc32)) // 500
    voc = Vocabulary(k=k, depth=depth, node_desc32=node_desc32,
                     children=ch_arr, word_id=word_id,
                     weights=np.ones(n_words, np.float32), n_words=n_words,
                     feature_level=max(depth - 4, 1) if depth > 1 else 0,
                     device=device)
    _, wids, _ = voc.transform(desc32)
    seen = {}
    for d, w in zip(doc_ids, wids):
        if w >= 0:
            seen.setdefault(int(w), set()).add(int(d))
    for w, docs in seen.items():
        counts[w] = len(docs)
    idf = np.log(n_docs / np.maximum(counts, 1e-9)).clip(0.01, None)
    voc.weights = idf.astype(np.float32)
    return voc
