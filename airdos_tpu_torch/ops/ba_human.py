"""The human BA's three edge families: CUDA kernel + plain twin.

airdos_tpu's human-trajectory BA (solvers/human_ba.py:188 residuals,
gn_step :257-301 and the cost sums of :223-243) evaluates, besides the
static projections (``ops/ba_static``), three families of edges between
the human vertices:

- joint projections [3 x 9]: a joint seen from its pose's keyframe, the
  static edges' stereo/mono projection (csrc/ba_project.cuh) with
  chi2 = (e.e) SigmaHuman and Huber delta 2.795483; variables camera (6)
  and joint (3);
- rigidity [1 x 7]: er = sqrt(|p1 - p2|^2 + 1e-12) - d, chi2 = er^2
  SigmaRigidity, delta thRanSacRigidity; variables p1, p2 (3 each) and the
  limb length d; J = [u, -u, -1], u = (p1 - p2) / dist;
- constant-velocity motion [3 x 12]: em = p1 - R^T (p2 - t dt), chi2 =
  (em.em) SigmaMotion, delta thHuberMotion; variables p1, p2 and the
  motion (t, omega); J = [I, -R^T, R^T dt, -[xm]x], xm = R^T (p2 - t dt).

Each family's weight is sigma (times the Huber factor when asked) times
its activity.  In Gauss-Newton mode (``human_edge_blocks``) one launch
writes every edge's J^T W J and -J^T W e entries as one column in
``solvers/human_ba.scatter_keys``' order: every family's J^T W J blocks
(row-major, projections, rigidity, motion), then every family's -J^T W e;
in cost mode (``human_edge_cost``) each edge's rho and chi2 (families in
that order) and the projections' depths; in cost-sum mode
(``human_edge_cost_sum``) the three families' LM costs [3], each bit-equal
to ``ops/lm_cost.lm_cost_ref(rho, active)`` of the cost mode's rho, without
rho going to memory (``human_cost_sum_ref``).

On CUDA tensors the three launch the sm_90a kernels of
``csrc/ba_human.cu`` (Gauss-Newton: ``LANES`` lanes an edge, each
computing the entries ``gn_lane_plan`` gives it, a block of one family;
cost: a thread an edge; cost sum: a block of 1024 threads a family) on
the calling thread's current stream (built with nvcc at first use into
``airdos_tpu_torch/_build/``, bound through ctypes) or raise, and count
the launch, by thread and stream priority too; on CPU tensors they run
``human_edges_ref``, which spells out each product and sum in the
kernel's order, so the two are bit-equal.  ``launch_tables`` checks a
solve's edge tables for the kernel once (``LaunchTables``); a launch then
checks only the state and the activities.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.ba_static import (COST, COST_SUM, ROWS, huber_ref,
                                            normal_rows, project_ref,
                                            sqnorm3, sqrt_rn)
from airdos_tpu_torch.ops.cuda_build import check_tensor, consts
from airdos_tpu_torch.ops.lm_cost import lm_cost_ref

# csrc/ba_human.cu's Gauss-Newton mode: each family's Jacobian rows and
# variables (R, Q); LANES lanes an edge, each with at most SLOTS[family]
# of the edge's entries
FAMILIES = ((3, 9), (1, 7), (3, 12))     # projection, rigidity, motion
LANES = 8
SLOTS = (7, 5, 12)
NONE = 255                        # a plan word's empty second place


class HumanTables(NamedTuple):
    """The three families' edge tables (solvers/human_ba.HumanEdges), int32
    indices."""
    hp_cam: torch.Tensor     # [Eh] observing camera
    hp_joint: torch.Tensor   # [Eh] flat joint index
    hp_obs: torch.Tensor     # [Eh, 3] float32 (u, v, uR)
    rg_j1: torch.Tensor      # [Er] segment endpoints
    rg_j2: torch.Tensor
    rg_seg: torch.Tensor     # [Er] flat (trajectory, part) limb index
    mo_j1: torch.Tensor      # [Em] torso joint at poses l and l + 1
    mo_j2: torch.Tensor
    mo_traj: torch.Tensor    # [Em] trajectory
    mo_dt: torch.Tensor      # [Em] float32 time from pose l to l + 1


class HumanCost(NamedTuple):
    rho: torch.Tensor   # [Eh + Er + Em] robust cost, families in order
    chi2: torch.Tensor  # [Eh + Er + Em]
    zh: torch.Tensor    # [Eh] the joints' depths in their cameras


class LaunchTables(NamedTuple):
    """A solve's HumanTables checked once for the kernel (contiguous CUDA
    int32 / float32 tensors of the families' lengths) and the ten tables'
    device pointers, as the kernel's C entry point takes them."""
    tables: HumanTables
    ptrs: ctypes.Array


Tables = Union[HumanTables, LaunchTables]


def tables_of(tb: Tables) -> HumanTables:
    return tb.tables if isinstance(tb, LaunchTables) else tb


def family_sizes(tb: Tables):
    tb = tables_of(tb)
    return tb.hp_cam.shape[0], tb.rg_j1.shape[0], tb.mo_j1.shape[0]


def n_values(tb: Tables) -> int:
    """The length of the Gauss-Newton column: (81 + 9) Eh + (49 + 7) Er +
    (144 + 12) Em."""
    Eh, Er, Em = family_sizes(tb)
    return 90 * Eh + 56 * Er + 156 * Em


def launch_tables(tb: HumanTables) -> LaunchTables:
    """tb checked for the kernel, with its pointers; raises unless every
    table is a contiguous CUDA tensor of its type and length."""
    dev = tb.hp_cam.device
    if not tb.hp_cam.is_cuda:
        raise ValueError(f"hp_cam must be a CUDA tensor, got {dev}")
    Eh, Er, Em = family_sizes(tb)
    f32, i32 = torch.float32, torch.int32
    for name, n in (("hp_cam", Eh), ("hp_joint", Eh), ("rg_j1", Er),
                    ("rg_j2", Er), ("rg_seg", Er), ("mo_j1", Em),
                    ("mo_j2", Em), ("mo_traj", Em)):
        check_tensor(name, getattr(tb, name), i32, (n,), dev)
    check_tensor("hp_obs", tb.hp_obs, f32, (Eh, 3), dev)
    check_tensor("mo_dt", tb.mo_dt, f32, (Em,), dev)
    if n_values(tb) >= 2 ** 31:
        raise ValueError(f"{Eh}, {Er}, {Em} edges exceed the kernel's "
                         f"indexing")
    return LaunchTables(tb, (ctypes.c_int64 * len(tb))(
        *(x.data_ptr() for x in tb)))


# ------------------------------------------------------------ lane plan

def gn_entries(fam: int) -> List[Tuple[int, int, int, int, bool]]:
    """The distinct entries of an edge's Q Q + Q Gauss-Newton floats in
    family `fam` (0 projection, 1 rigidity, 2 motion), in the plan's
    order: (q, p, first place, second place or NONE, negate), each sum_r
    (w A[r, q]) A[r, p] over the columns A = [J (0 .. Q - 1) | e (Q)].
    J^T w J is symmetric bit for bit (w A[r, q] is exact in float64), so
    its upper triangle goes to both places; -J^T w e is at Q Q + q."""
    Q = FAMILIES[fam][1]
    out = [(q, p, q * Q + p, NONE if q == p else p * Q + q, False)
           for q in range(Q) for p in range(q, Q)]
    out.extend((q, Q, Q * Q + q, NONE, True) for q in range(Q))
    return out


def gn_lane_plan(fam: int) -> List[List[int]]:
    """[LANES][SLOTS[fam]] plan words of family `fam`: entry k of
    gn_entries goes to lane k % LANES, slot k // LANES; a word is q | p
    << 4 | first << 8 | second << 16 | negate << 24, -1 for an empty slot
    (csrc/ba_human.cu Plan)."""
    plan = [[-1] * SLOTS[fam] for _ in range(LANES)]
    for k, (q, p, first, second, neg) in enumerate(gn_entries(fam)):
        plan[k % LANES][k // LANES] = (q | p << 4 | first << 8
                                       | second << 16 | int(neg) << 24)
    return plan


def plan_entry(word: int) -> Tuple[int, int, int, int, bool]:
    """A plan word unpacked: (q, p, first place, second place, negate)."""
    return (word & 15, (word >> 4) & 15, (word >> 8) & 255,
            (word >> 16) & 255, bool((word >> 24) & 1))


# ------------------------------------------------------------ plain version

def human_cost_sum_ref(rho: torch.Tensor, act: Sequence[torch.Tensor],
                       sizes: Sequence[int]) -> torch.Tensor:
    """The three families' LM costs [3] float32: lm_cost_ref of each
    family's rho (the families in order in rho) and activity."""
    return torch.stack([lm_cost_ref(r, a)
                        for r, a in zip(rho.split(list(sizes)), act)])


class FamilyRows(NamedTuple):
    """One family's edges in the plain version."""
    e: torch.Tensor                  # [E, R] residuals
    J: torch.Tensor                  # [E, R, Q] Jacobian
    chi2: torch.Tensor               # [E]
    factor: Optional[torch.Tensor]   # [E] Huber weight factor (None: off)
    rho: torch.Tensor                # [E] robust cost


def human_families_ref(camR, camt, joints, seg_len, motR, mott, tb: Tables,
                       cam, sig: Sequence[float], use_huber: bool):
    """The three families' FamilyRows (projection, rigidity, motion) and
    the projections' depths [Eh], in the kernel's order of operations."""
    tb = tables_of(tb)
    dev = joints.device
    s_h, s_r, s_m = sig[:3]
    deltas = [torch.tensor(d, dtype=torch.float32, device=dev)
              for d in sig[3:]]
    jflat = joints.reshape(-1, 3)
    hp_cam = tb.hp_cam.long()
    eh, Jch, Jxh, zh, _ = project_ref(camR[hp_cam], camt[hp_cam],
                                      jflat[tb.hp_joint.long()], tb.hp_obs,
                                      cam)
    chi_h = sqnorm3(eh) * s_h

    diff = jflat[tb.rg_j1.long()] - jflat[tb.rg_j2.long()]
    dist = sqrt_rn(sqnorm3(diff) + 1e-12)
    er = dist - seg_len.reshape(-1)[tb.rg_seg.long()]
    u = diff / dist[:, None]
    chi_r = er * er * s_r

    traj = tb.mo_traj.long()
    Rm = motR[traj]
    v = jflat[tb.mo_j2.long()] - mott[traj] * tb.mo_dt[:, None]
    xm = (Rm[:, 0, :] * v[:, 0:1] + Rm[:, 1, :] * v[:, 1:2]) \
        + Rm[:, 2, :] * v[:, 2:3]                            # R^T v
    em = jflat[tb.mo_j1.long()] - xm
    chi_m = sqnorm3(em) * s_m

    E_m = em.shape[0]
    zero = torch.zeros_like(xm[:, 0])
    x, y, z = xm[:, 0], xm[:, 1], xm[:, 2]
    neg_hat = torch.stack([torch.stack([zero, z, -y], -1),
                           torch.stack([-z, zero, x], -1),
                           torch.stack([y, -x, zero], -1)], -2)
    RmT = Rm.transpose(1, 2)
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(E_m, 3, 3)
    J_m = torch.cat([eye, -RmT, RmT * tb.mo_dt[:, None, None], neg_hat],
                    dim=2)                                   # [Em, 3, 12]
    J_r = torch.cat([u, -u, torch.full_like(er, -1.0)[:, None]],
                    dim=1)[:, None, :]                       # [Er, 1, 7]
    J_h = torch.cat([Jch, Jxh], dim=2)                       # [Eh, 3, 9]
    fams = [FamilyRows(e, J, chi2, *huber_ref(chi2, d, use_huber))
            for e, J, chi2, d in ((eh, J_h, chi_h, deltas[0]),
                                  (er[:, None], J_r, chi_r, deltas[1]),
                                  (em, J_m, chi_m, deltas[2]))]
    return fams, zh


def family_weights(fams, sig: Sequence[float],
                   act: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each family's Gauss-Newton weight [E]: sigma (times the Huber
    factor) times the activity."""
    return [(s if f.factor is None else s * f.factor) * a
            for f, s, a in zip(fams, sig[:3], act)]


def human_edges_ref(camR, camt, joints, seg_len, motR, mott, tb: Tables,
                    act: Optional[Sequence[torch.Tensor]], cam,
                    sig: Sequence[float], use_huber: bool, mode: int):
    """Plain torch version: the Gauss-Newton column [n_values(tb)] (mode
    ROWS), HumanCost (COST) or the families' LM costs [3] (COST_SUM).
    sig: (SigmaHuman, SigmaRigidity, SigmaMotion, and the Huber deltas of
    the three families)."""
    fams, zh = human_families_ref(camR, camt, joints, seg_len, motR, mott,
                                  tb, cam, sig, use_huber)
    rho = torch.cat([f.rho for f in fams])
    if mode == COST_SUM:
        return human_cost_sum_ref(rho, act, family_sizes(tb))
    if mode == COST:
        return HumanCost(rho=rho, chi2=torch.cat([f.chi2 for f in fams]),
                         zh=zh)
    blocks = [normal_rows(f.J, w, f.e)
              for f, w in zip(fams, family_weights(fams, sig, act))]
    return torch.cat([H.reshape(-1) for H, _ in blocks]
                     + [b.reshape(-1) for _, b in blocks])


# ------------------------------------------------------------------ kernel

_SOURCE = cuda_build.CSRC / "ba_human.cu"
_SIGNATURES = {
    "airdos_human_edges": [ctypes.c_void_p] * 6
    + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 5,
}
_kernel = None                   # the bound C entry point, once loaded
_PLAN = (ctypes.c_int32 * (LANES * sum(SLOTS)))(
    *(w for fam in range(3) for lane in gn_lane_plan(fam) for w in lane))

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("human_edge_blocks", thread name, stream priority): launches}
    since the last reset_launches()."""
    return {("human_edge_blocks",) + key: n
            for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/ba_human.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def human_edges_cuda(camR, camt, joints, seg_len, motR, mott, tb: Tables,
                     act: Optional[Sequence[torch.Tensor]], cam,
                     sig: Sequence[float], use_huber: bool, mode: int):
    """Launch the sm_90a kernel of `mode` on the current stream:
    human_edges_ref's column, HumanCost or LM costs.  tb: the solve's
    LaunchTables, or HumanTables, checked on this call."""
    global _kernel
    dev = joints.device
    if not joints.is_cuda:
        raise ValueError(f"joints must be a CUDA tensor, got {dev}")
    if mode not in (ROWS, COST, COST_SUM):
        raise ValueError(f"mode {mode}")
    lt = tb if isinstance(tb, LaunchTables) else launch_tables(tb)
    if lt.tables.hp_cam.device != dev:
        raise ValueError(f"the edge tables are on {lt.tables.hp_cam.device}"
                         f", the state on {dev}")
    f32 = torch.float32
    C, T = camR.shape[0], motR.shape[0]
    Eh, Er, Em = family_sizes(lt)
    check_tensor("camR", camR, f32, (C, 3, 3), dev)
    check_tensor("camt", camt, f32, (C, 3), dev)
    if joints.dim() < 1 or joints.shape[-1] != 3:
        raise ValueError(f"joints must be [..., 3], got {tuple(joints.shape)}")
    check_tensor("joints", joints, f32, tuple(joints.shape), dev)
    check_tensor("seg_len", seg_len, f32, tuple(seg_len.shape), dev)
    check_tensor("motR", motR, f32, (T, 3, 3), dev)
    check_tensor("mott", mott, f32, (T, 3), dev)
    if mode != COST:
        for name, a, n in zip(("act_h", "act_r", "act_m"), act,
                              (Eh, Er, Em)):
            check_tensor(name, a, f32, (n,), dev)
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE,
                                     _SIGNATURES).airdos_human_edges
    if mode == COST:
        out = HumanCost(*(torch.empty(n, dtype=f32, device=dev)
                          for n in (Eh + Er + Em, Eh + Er + Em, Eh)))
        ptrs = [x.data_ptr() for x in out]
    else:
        out = torch.empty(n_values(lt) if mode == ROWS else 3, dtype=f32,
                          device=dev)
        ptrs = [out.data_ptr(), None, None]
    acts = [None] * 3 if mode == COST else [a.data_ptr() for a in act]
    with cuda_build.on_device(dev):
        err = _kernel(camR.data_ptr(), camt.data_ptr(), joints.data_ptr(),
                      seg_len.data_ptr(), motR.data_ptr(), mott.data_ptr(),
                      lt.ptrs, *acts, Eh, Er, Em, consts(*cam, *sig),
                      int(use_huber), int(mode),
                      _PLAN if mode == ROWS else None, *ptrs,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"human_edge_blocks kernel launch failed: "
                           f"cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return out


def _human_edges(*args):
    if args[2].is_cuda:
        return human_edges_cuda(*args)
    return human_edges_ref(*args)


def human_edge_blocks(camR, camt, joints, seg_len, motR, mott, tb: Tables,
                      act: Sequence[torch.Tensor], cam,
                      sig: Sequence[float], use_huber: bool) -> torch.Tensor:
    """The three families' Gauss-Newton column [n_values(tb)] float32.
    camR [C, 3, 3], camt [C, 3], joints [..., 3] (flat joint index),
    seg_len (flat limb index), motR [T, 3, 3], mott [T, 3], act (per family
    [E] float32); cam (fx, fy, cx, cy, bf); sig as human_edges_ref takes
    it.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    return _human_edges(camR, camt, joints, seg_len, motR, mott, tb, act,
                        cam, sig, use_huber, ROWS)


def human_edge_cost(camR, camt, joints, seg_len, motR, mott, tb: Tables,
                    cam, sig: Sequence[float], use_huber: bool) -> HumanCost:
    """The three families' (rho, chi2, projection depths), as
    human_edge_blocks takes its arguments."""
    return _human_edges(camR, camt, joints, seg_len, motR, mott, tb, None,
                        cam, sig, use_huber, COST)


def human_edge_cost_sum(camR, camt, joints, seg_len, motR, mott, tb: Tables,
                        act: Sequence[torch.Tensor], cam,
                        sig: Sequence[float], use_huber: bool
                        ) -> torch.Tensor:
    """The three families' LM costs [3] float32, each bit-equal to
    ops/lm_cost.lm_cost_ref(rho, active) of its family's rho in
    human_edge_cost, as human_edge_blocks takes its arguments."""
    return _human_edges(camR, camt, joints, seg_len, motR, mott, tb, act,
                        cam, sig, use_huber, COST_SUM)
