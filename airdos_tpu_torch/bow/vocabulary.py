"""Bag-of-words vocabulary: array-flattened k-ary tree.

Rebuild of DBoW2's TemplatedVocabulary (reference Thirdparty/DBoW2) as
airdos_tpu/bow/vocabulary.py holds it: a k-branching, L-level tree of
binary ORB descriptors with TF-IDF weights and L1 scoring, kept as flat
arrays.  The descent of a whole frame's descriptors runs on the
vocabulary's torch device: one launch of csrc/voc_transform.cu on the
card, its plain version (ops/voc_kernels.py) on the CPU.  Training
(binary k-medoids by bit majority) is host numpy and gives the same
tree as airdos_tpu from the same descriptors and seed.  The DBoW2 text
(ORBvoc.txt) and binary (to_binary.cc) files load with numpy host
parsers, as in airdos_tpu; the text loader keeps a ``<path>.npz`` cache
beside the file.
"""
from __future__ import annotations

import dataclasses
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from airdos_tpu_torch.convert import desc_to_tensor, resolve_device
from airdos_tpu_torch.ops import voc_kernels as vk


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
        self._tables_lock = threading.Lock()

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
        """The tree on the device, uploaded once, as int32: children, node
        words (bit views), word ids, groups.  Online, the tracking
        thread (BoW tracking, relocalization) and the mapping worker (the
        database, loop detection) read the tables from their own streams,
        and either may come first: the upload runs once under a lock, and
        on the card the uploading stream is synchronized before the tables
        are published, so a reader on any stream finds them complete.  The
        tables live as long as the vocabulary, so no stream's later
        allocation can reuse their memory."""
        tables = self._tables
        if tables is None:
            with self._tables_lock:
                if self._tables is None:
                    up = tuple(
                        torch.from_numpy(np.ascontiguousarray(x).view(
                            np.int32) if x.dtype == np.uint32 else
                            x.astype(np.int32)).to(self.device)
                        for x in (self.children, self.node_desc32,
                                  self.word_id, self._group_of_node))
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                    self._tables = up
                tables = self._tables
        return tables

    def __getstate__(self):
        # copy.deepcopy and pickle: the lock is remade on the other side
        state = dict(self.__dict__)
        del state["_tables_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._tables_lock = threading.Lock()

    def _transform_device(self, desc32: torch.Tensor):
        """desc32 [N, 8] int32 bit views -> (word ids [N], node at the
        feature level [N]), int32: the tree descent (first child on ties,
        like jnp.argmin), one voc_transform launch on a CUDA tensor."""
        return vk.voc_transform(*self._device_tables(), desc32, self.depth)

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


def _from_node_records(k: int, depth: int, parents, descs_u8, wts, leaf,
                       device="cuda") -> Vocabulary:
    """Assemble a Vocabulary from per-node records in DBoW2 file order
    (node ids 1..n implied by order; word ids in leaf read order).
    Vectorized: per-record Python loops cost minutes at ORBvoc scale
    (~10^6 records)."""
    parents = np.asarray(parents, np.int64)
    leaf = np.asarray(leaf, bool)
    wts = np.asarray(wts, np.float32)
    n = len(parents) + 1   # + root
    node_desc = np.zeros((n, 32), np.uint8)
    if n > 1:
        node_desc[1:] = np.asarray(descs_u8, np.uint8)
    # children slots: records appear in id order, so a stable sort by
    # parent gives each child its within-parent rank = position - first
    # occurrence of that parent in the sorted order
    children = np.full((n, k), -1, np.int32)
    if n > 1:
        ids = np.arange(1, n, dtype=np.int64)
        order = np.argsort(parents, kind="stable")
        ps = parents[order]
        newp = np.empty(len(ps), bool)
        newp[0] = True
        newp[1:] = ps[1:] != ps[:-1]
        first = np.maximum.accumulate(np.where(newp, np.arange(len(ps)), 0))
        rank = np.arange(len(ps)) - first
        if rank.size and int(rank.max()) >= k:
            raise ValueError(f"node with more than k={k} children")
        children[ps, rank] = ids[order].astype(np.int32)
    word_id = np.full(n, -1, np.int32)
    leaf_rows = np.nonzero(leaf)[0]
    word_id[leaf_rows + 1] = np.arange(len(leaf_rows), dtype=np.int32)
    return Vocabulary(k=k, depth=depth, node_desc32=_pack_u32(node_desc),
                      children=children, word_id=word_id,
                      weights=np.asarray(wts[leaf_rows], np.float32),
                      n_words=int(len(leaf_rows)), device=device)


_NODE_RECORD = np.dtype([("parent", "<i4"), ("desc", "u1", 32),
                         ("weight", "<f4"), ("leaf", "u1")])
_BINARY_HEADER = "<u4, <u4, <i4, <i4, <i4, <i4"


def load_dbow2_binary(path: str | Path, device="cuda") -> Vocabulary:
    """Load the DBoW2 binary format written by saveToBinaryFile /
    Vocabulary/to_binary.cc (reference TemplatedVocabulary.h:1671-1716):
    little-endian header [u32 n_nodes_incl_root, u32 size_node, i32 k,
    i32 L, i32 scoring, i32 weighting], then one 41-byte record per
    non-root node in id order: [i32 parent, 32xu8 descriptor, f32 weight,
    u8 is_leaf]."""
    raw = Path(path).read_bytes()
    _, size_node, k, depth, _, _ = np.frombuffer(raw[:24],
                                                 dtype=_BINARY_HEADER)[0]
    if size_node != _NODE_RECORD.itemsize:
        raise ValueError(f"unexpected DBoW2 node size {size_node}")
    n_rec = (len(raw) - 24) // size_node
    nodes = np.frombuffer(raw[24:24 + n_rec * size_node], dtype=_NODE_RECORD)
    return _from_node_records(int(k), int(depth), nodes["parent"],
                              nodes["desc"], nodes["weight"],
                              nodes["leaf"] != 0, device=device)


def save_dbow2_binary(voc: Vocabulary, path: str | Path):
    """Write the DBoW2 binary format (see load_dbow2_binary): node records
    in id order, scoring 0 (L1_NORM) and weighting 0 (TF_IDF), the DBoW2
    defaults ORBvoc uses."""
    n = len(voc.word_id)
    parent = np.zeros(n, np.int32)
    pids, slots = np.nonzero(voc.children >= 0)
    parent[voc.children[pids, slots]] = pids
    desc_u8 = voc.node_desc32.view(np.uint8).reshape(n, 32) \
        if voc.node_desc32.dtype == np.uint32 else voc.node_desc32
    nodes = np.zeros(n - 1, dtype=_NODE_RECORD)
    nodes["parent"] = parent[1:]
    nodes["desc"] = desc_u8[1:]
    is_leaf = voc.word_id[1:] >= 0
    nodes["leaf"] = is_leaf
    wts = np.zeros(n - 1, np.float32)
    wts[is_leaf] = voc.weights[voc.word_id[1:][is_leaf]]
    nodes["weight"] = wts
    with open(path, "wb") as f:
        f.write(np.asarray([(n, _NODE_RECORD.itemsize, voc.k, voc.depth, 0,
                             0)], dtype=_BINARY_HEADER).tobytes())
        f.write(nodes.tobytes())


def load_dbow2_text(path: str | Path, cache: bool = True,
                    device="cuda") -> Vocabulary:
    """Load the DBoW2 text format (first line: k L scoring weighting; then
    one node per line: parent_id is_leaf d0..d31 weight), as written by
    TemplatedVocabulary::saveToTextFile: the ORBvoc.txt format.  Parsed in
    bulk with np.loadtxt; a one-time ``<path>.npz`` cache beside the file
    makes later loads a single npz read."""
    path = Path(path)
    cache_path = path.with_suffix(path.suffix + ".npz")
    if cache and cache_path.exists() and \
            cache_path.stat().st_mtime >= path.stat().st_mtime:
        return Vocabulary.load_npz(cache_path, device=device)
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if data.size == 0:
        data = data.reshape(0, 35)
    voc = _from_node_records(k, depth, data[:, 0].astype(np.int64),
                             data[:, 2:34].astype(np.uint8),
                             data[:, 34].astype(np.float32), data[:, 1] != 0,
                             device=device)
    if cache:
        try:
            voc.save_npz(cache_path)
        except OSError:
            pass          # read-only vocabulary directory: no cache
    return voc
