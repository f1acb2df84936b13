"""Carrying state across from numpy (and from airdos_tpu) to the port.

- ``config_from``: any SlamConfig-shaped dataclass (airdos_tpu's included)
  -> this package's SlamConfig, through a ``dataclasses.asdict`` round trip.
- ``resolve_device``: the device an entry point was given, checked (the
  default is the card; without one it raises and names ``device="cpu"``).
- ``desc_to_tensor`` / ``desc_to_numpy``: uint32 descriptor words <-> the
  int32 bit-view tensors the port computes with.
- ``step_tables_to_device``: the packed fused-step tables that tracking
  builds on the host (last-frame points, local-map candidates and their
  descriptors) -> device tensors.
- ``vocabulary_from`` / ``map_from``: airdos_tpu's Vocabulary and SlamMap
  (point table, keyframes, covisibility, spanning tree, loop edges, BoW
  vectors, observations, human trajectories) copied into the port's, so
  that one mapping step can run on identical state in both packages;
- ``loop_closer_state_from``: an airdos_tpu LoopCloser's detection state
  (consistent groups, last loop keyframe, the RANSAC generator's state)
  copied into the port's, so both packages' loop closers continue from
  one point.

Nothing here imports jax: airdos_tpu objects are read through their
dataclass fields and numpy arrays.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from airdos_tpu_torch.config import (CameraConfig, DeviceConfig, HumanConfig,
                                     OptimizerConfig, OrbConfig,
                                     SchedulerConfig, SlamConfig, SystemFlags)

_SECTIONS = {"camera": CameraConfig, "orb": OrbConfig, "human": HumanConfig,
             "optimizer": OptimizerConfig, "system": SystemFlags,
             "scheduler": SchedulerConfig, "device": DeviceConfig}


def config_from(cfg) -> SlamConfig:
    """Copy a SlamConfig dataclass of either package into this package's
    SlamConfig.  Raises TypeError on a field this package does not know."""
    d = dataclasses.asdict(cfg)
    kw = {k: _SECTIONS[k](**d.pop(k)) for k in list(d) if k in _SECTIONS}
    return SlamConfig(**kw, **d)


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device where torch sees none raises.
    The entry points run on the card unless the caller names the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r}: torch sees no CUDA device; "
                           'pass device="cpu" to run on the CPU')
    return dev


def desc_to_tensor(desc32: np.ndarray, device) -> torch.Tensor:
    """uint32 [N, 8] descriptor words -> int32 bit-view tensor on device."""
    a = np.ascontiguousarray(desc32, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def desc_to_numpy(desc32: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> uint32 [N, 8] numpy words."""
    return desc32.detach().cpu().numpy().view(np.uint32)


def to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a device tensor (dtype converted on the host)."""
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    return torch.from_numpy(a).to(device)


def step_tables_to_device(last_f32: np.ndarray, desc_p: np.ndarray,
                          cand_f32: np.ndarray, desc_c: np.ndarray, device):
    """The fused step's packed host tables -> device tensors:
    last_f32 [Np, 8] f32, desc_p [Np, 8] u32, cand_f32 [Pc, 9] f32,
    desc_c [Pc, 8] u32."""
    return (to_device(last_f32, device, np.float32),
            desc_to_tensor(desc_p, device),
            to_device(cand_f32, device, np.float32),
            desc_to_tensor(desc_c, device))


def vocabulary_from(voc, device="cuda"):
    """A Vocabulary of either package -> this package's, on `device`."""
    from airdos_tpu_torch.bow.vocabulary import Vocabulary
    return Vocabulary(k=int(voc.k), depth=int(voc.depth),
                      node_desc32=np.array(voc.node_desc32, np.uint32),
                      children=np.array(voc.children, np.int32),
                      word_id=np.array(voc.word_id, np.int32),
                      weights=np.array(voc.weights, np.float32),
                      n_words=int(voc.n_words),
                      feature_level=int(voc.feature_level), device=device)


_POINT_COLUMNS = ("pos", "desc32", "normal", "min_dist", "max_dist", "n_obs",
                  "visible", "found", "bad", "ref_kf", "first_kf")


def _host_copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) \
        else copy.deepcopy(v)


def map_from(src):
    """A SlamMap of either package -> an independent copy as this
    package's SlamMap: every point column and observation dict, and every
    keyframe attribute (poses, measurements, feature->point table,
    covisibility, spanning tree, loop edges, culling state, BoW vector,
    word and node ids) and every human trajectory with its poses by value.
    A keyframe's membership of the source's keyframe database is not
    carried: the copy is in no database until one adds it."""
    from airdos_tpu_torch.slam.map import (HumanPose, HumanTrajectory,
                                           KeyFrame, SlamMap)
    m = SlamMap()
    sp, pt = src.points, m.points
    n = int(sp.n)
    pt.alloc(n)
    for name in _POINT_COLUMNS:
        getattr(pt, name)[:n] = getattr(sp, name)[:n]
    pt.obs[:n] = [dict(o) for o in sp.obs[:n]]
    for kid, skf in src.kfs.items():
        kf = KeyFrame.__new__(KeyFrame)
        for k, v in vars(skf).items():
            if k != "_in_db":
                setattr(kf, k, _host_copy(v))
        m.kfs[kid] = kf
    for tid, straj in src.trajectories.items():
        traj = HumanTrajectory(tid)
        for k, v in vars(straj).items():
            if k != "poses":
                setattr(traj, k, _host_copy(v))
        traj.poses = [HumanPose(**{f.name: _host_copy(getattr(hp, f.name))
                                   for f in dataclasses.fields(HumanPose)})
                      for hp in straj.poses]
        m.trajectories[tid] = traj
    m.optimized_track_ids = set(src.optimized_track_ids)
    m.current_track_ids = list(src.current_track_ids)
    m.next_kf_id = src.next_kf_id
    m.max_kf_id = src.max_kf_id
    return m


def loop_closer_state_from(src, dst) -> None:
    """Copy a LoopCloser's detection state (either package's) into dst:
    the covisibility groups that count consecutive detections, the last
    loop keyframe, the closed-loop count and the numpy Generator the Sim3
    RANSAC draws its samples from."""
    dst._consistent_groups = [(set(g), int(c))
                              for g, c in src._consistent_groups]
    dst._last_loop_kf = src._last_loop_kf
    dst.n_loops_closed = src.n_loops_closed
    dst.rng.bit_generator.state = copy.deepcopy(src.rng.bit_generator.state)
