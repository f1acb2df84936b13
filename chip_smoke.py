"""Smoke test of airdos_tpu_torch on one NVIDIA GPU (sm_90a: H100 / H200).

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # where a frame's and a keyframe's time goes

Run from the repository root.  Phases, each of which fails the run:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, whether nvcc is present; a CUDA device is required;
2. build: the nineteen sources of csrc/ (hamming.cu, segment_sum.cu,
   pose_lm.cu, fast.cu, orb_desc.cu, pyramid.cu, select.cu, stereo_sad.cu,
   disparity.cu, ba_static.cu, ba_points.cu, ba_human.cu, match.cu,
   triangulate.cu, ba_global.cu, sim3_edges.cu, ransac.cu, sim3_opt.cu,
   voc_transform.cu) compiled with nvcc for sm_90a, all at once (build
   seconds);
3. slice: tracking only, Tracking(cfg, FrontEnd(cfg, "cuda"), SlamMap(),
   local_mapper=None) (airdos_tpu's tracking-only configuration), over 28
   bench frames of the synthetic world at the reference budget (640x360,
   1500 ORB features, 8 levels): every frame OK, >= 5 keyframes, ATE <
   0.02 m, >= 2 pose_lm launches on every fused ("fast") frame, and on
   every fused frame >= 3 match_rows launches (stereo, motion-model and
   local-map matches), >= 2 of them with the resolve in the launch
   (counted as match_resolve: csrc/match.cu has no other kernel) and no
   2-D Hamming launch,
   and on every frame one pyramid, one fast_nms, one select and one
   orb_desc launch an image, each over all the image's levels (2 each),
   and one stereo_sad launch (the matcher and front-end launches held on
   every frame of phases 4-5 too);
4. mapping: System(cfg, device="cuda") over the same 28 frames, quantized
   to uint8 as a dataset's PNGs hold them (phase 14a's in-memory twin),
   with the budgets of bench.py's static configuration: every frame OK, >= 5
   keyframes inserted, ATE < 0.02 m, triangulation created points, the
   static BA solved at every keyframe after the third, a match_rows
   launch in fuse mode (fusion) on every keyframe frame after the first,
   every fusion call one such launch and no batched Hamming launch, one
   match_rows launch in epipolar mode and one triangulate launch
   (triangulation) on each keyframe frame with a neighbour past the
   stereo baseline and none elsewhere, 45 segment_sum
   launches per BA solve (3 per Gauss-Newton step), and per solve 34
   static_edge_blocks (15 steps, 17 LM costs in its cost-sum mode, 2
   chi-square passes), 15 landmark_reduce and 15 landmark_backsub
   launches; prints the fusion write-back's split under the map lock
   (map.descriptors, map.normals, map.connections) and, on the final
   map, the batched descriptor refresh (airdos_tpu_torch/native) against
   the per-point loop it replaced, which must agree;
5. human: the AirDOS flagship on bench.py sections 2-3's crowd scene
   (SyntheticStereoWorld(seed=2, n_points=500, n_humans=10, crowd=True),
   trajectory(27, 0.1, yaw_rate=0.005), humans rendered; the images
   quantized to uint8, the detections as float64, as phase 14b's reader
   gives them, so that the flagship is its in-memory twin): System with
   bench.py's _cfg(True) (masked extraction, stereo human association,
   the human-trajectory BA every Camera.fps = 5 frames, 8 trajectories x
   8 poses), then the polluted static run (no mask, no human layer) on
   the same frames: every flagship frame OK, >= 1 long trajectory
   optimized, a human BA solve at every cadence tick with long
   trajectories, 45 segment_sum launches per static BA solve and 60 per
   human BA solve (4 per Gauss-Newton step), the static solve's launches
   of phase 4 and per human BA solve 34 static_edge_blocks, 34
   human_edge_blocks (15 steps, 17 LM costs of the three families in its
   cost-sum mode, 2 chi-square passes), 15 landmark_reduce and 15
   landmark_backsub launches, ATE_human < 0.6 ATE_static
   and < 0.03 m; prints both ATEs, the human BA's reduced dimension D, the
   per-frame latency of tracking, keyframe and human-BA frames and the
   median human_ba span;
6. reloc: the blackout of tests/test_relocalization.py at the bench
   budget on the static-28 frames (no new rendering): frames 0-17, three
   all-zero frames, five repeats of frame 17: every frame before the
   blackout OK, LOST during it, OK at the end having relocalized at frame
   >= 21 (BoW candidates -> SearchByBoW -> EPnP RANSAC -> pose LM), a
   match_rows launch with the resolve, a voc_transform and the EPnP
   RANSAC's epnp_hypotheses and epnp_refine launches (one each a
   candidate) in the relocalizing frame, no TUM step > 0.12 m, ATE <
   max(2 x the uninterrupted run's on the same frames, 0.05 m); prints
   the EPnP inliers, the candidates tried and the frame's latency beside
   the eager RANSAC's (PERF.md);
7. loop: tests/test_loop_closure.py's pillar orbit (84 frames, Camera.fps
   5, enable_loop_closing) at the bench budget: every frame OK, a loop
   closed with a loop edge, ATE < 0.15 m, an epipolar match_rows and a
   triangulate (triangulation), a match_rows (the BoW and Sim3 matches)
   and a fuse-mode match_rows (SearchAndFuse) launch in every loop frame,
   every Sim3 match call two match_rows launches (one a direction) and no
   Hamming launch, every fusion call one fuse-mode match_rows launch and
   no batched Hamming launch, and per frame 45 segment_sum
   launches per static BA solve plus 100 per loop closure (20 for the
   essential graph, one a step; 80 for the global BA, 4 a step in four
   calls of five steps), and per loop closure 41 sim3_edges launches (a
   Gauss-Newton and a cost launch a step of the essential graph, and its
   first cost) and 960 schur_point and 960 schur_camera launches (48 each
   a global BA step), and in every loop frame the Sim3 RANSAC's
   horn_hypotheses and horn_refine (as many of one as of the other) and
   a sim3_opt launch; prints the loop's (keyframe, candidate, matches,
   loop points), the loop spans (sim3.ransac, sim3.optimize and
   loop.detect beside the eager versions', PERF.md) and the per-frame
   latency medians;
8. map scale: the global BA in GlobalBA's schedule over
   tests/test_global_ba.py's corridor at C = 1000 keyframes, P = 100,000
   points, ~300 observations a keyframe, and the essential graph over the
   same 1000 keyframes with one loop edge (D = 7000): every free keyframe
   moves, the global BA cuts the reprojection chi2 a hundredfold (its
   error to the truth is printed: see phase_map_scale), the essential
   graph halves the loop end's error, two card runs bit-equal; a global
   BA solve launches 80 segment_sum, 960 schur_point and 960 schur_camera,
   an essential graph 20 segment_sum and 41 sim3_edges and runs no
   autograd pass; prints solve times, device busy time (torch.profiler)
   and peak memory;
9. kernel: each kernel against its plain torch version, with per-call
   times of both (CUDA events, median of 20 samples of 10 back-to-back
   calls) and the kernel's device time (CUDA events around a CUDA graph of
   100 launches, each after a 64 MB write that evicts the L2, the writes'
   own time taken off; and back to back, L2 hot; torch.profiler's reading
   too on the first fixed shape, for comparison), its bound (the larger
   of its bytes over 3.35 TB/s and its operations over the card's peak
   rate) and the cold device time's share of it, and at the path's shapes
   one PyTorch library call that computes the same function, timed per
   call the same way and used nowhere in the port (segment_sum:
   index_add_; Hamming: torch.cdist(p=0) on the descriptors unpacked to
   float {0, 1} [.., 256], unpacked outside the timed window; none for
   the pose LM, FAST + NMS, orb_desc, the pyramid, selection,
   stereo_sad, patch_disparity, the BA kernels, the matcher kernels,
   triangulate, the loop solvers' kernels, the RANSACs, sim3_opt and
   voc_transform):
   - the 2-D Hamming kernel at 1536x1536, 2048x1536 and a ragged
     1500x1337 of random words: exact equality; no path launches it, so
     it is held exact, 2-D and batched, at triangulation's recorded
     descriptors too (B = 4 x 1536 x 1536 at this budget, and 1536x1536
     against the first neighbour's);
   - every kernel at every shape the path phases launched it with, on the
     first inputs the path gave it at that shape (recorded while the paths
     ran): segment_sum bit-equal
     to its plain version (index_add_) on a CPU copy and two launches
     bit-equal to each other; pose_lm (by edge count, prior on or off)
     within tests/test_torch_pose.py's tolerances of its plain version on
     the card (R 1e-4, t 1e-4 m, >= 99% of inlier flags equal), two
     launches bit-equal, its device time from a graph of 20 launches;
     fast_nms (by the image's level shapes, one launch an image)
     bit-equal to its per-level launches and to its plain version, the
     per-level launches' device time beside it; orb_desc (by the image's
     level shapes and quotas, one launch an image) bit-equal to its
     per-level launches and to its plain version, or else within 1e-3
     degrees with >= 99.9% of the descriptors equal, the differing angles
     and words counted; pyramid (by the image's size, levels, mask type
     and erosion, one cooperative launch an image: every level's image,
     mask and blur; at each size the paths launched with a uint8 mask
     also with that mask as float32 and with none) bit-equal to the
     per-level launches of its one-level kernel and to its plain version,
     its grid and grid barriers and the per-level launches' device time
     beside it; select (by the image's level shapes and quotas: xs, ys,
     responses) and patch_disparity bit-equal; stereo_sad (by keypoints and levels)
     bit-equal where every pixel is 0 or >= 2^-8 (ops/stereo_sad.py's
     condition), else >= 99.9% of accept flags equal and u_right within
     1e-3 px where both accept; static_edge_blocks (by edges, cameras,
     points and mode: Gauss-Newton rows, costs, or the LM cost sum),
     landmark_reduce and landmark_backsub (by points
     and cameras) and human_edge_blocks (by family sizes and mode:
     Gauss-Newton column, costs, or the three families' LM cost sums,
     which are also held against ops/lm_cost.py's lm_cost_ref of each
     family's cost-mode rho on the card) bit-equal, two launches
     bit-equal; match_rows (by mode, rows, columns, targets, the resolve
     and its rotation filter; fuse mode at B = 9 and 1 x 2048 x 1536 as
     fusion and SearchAndFuse launched it, epipolar mode at B = 4 x 1536
     x 1536 as triangulation launched it) bit-equal in every output to
     its plain version (the resolve's outputs to match_resolve_ref's), two
     launches equal, and on tests/torch_match_cases.py's edge cases of the
     grid of cells in every mode; beside it the time per call of the eager
     composition it replaced (its plain version around the 2-D Hamming
     kernel, or the batched one in fuse and epipolar mode), the full
     scan's bound (the gate at every pair) beside the bound, and for
     match_resolve (the launches that ran the resolve) the same call's
     device time without the resolve; triangulate (by neighbours, rows
     and a neighbour's features) bit-equal to its plain version in every
     output, two launches equal, beside it the per-call time of the eager
     triangulation it replaced (tests/torch_triangulate_cases.py) and of
     the whole triangulate_pair against the whole composition on the
     path's inputs; schur_point and schur_camera (by edges, points,
     cameras and raw mode, recorded at their prepared launchers' calls;
     each launch of schur_camera on its own copy of the recorded CG state)
     bit-equal to their plain versions on a CPU copy (whose segment sums
     are index_add_ in walk order), two launches
     bit-equal, the per-call time of a launch prepared once beside the
     one-shot call's, schur_point beside the eager composition it
     replaced;
     sim3_edges (by vertices, edges and mode): the cost within SYSTEM_RTOL
     of its plain version's (the residuals' torch.sum) on the card, the
     system held to the plain version in float64 (the reverse-mode
     Jacobians and scatter_values) edge by edge, J^T J within SYSTEM_RTOL
     of its largest entry and J^T e within SYSTEM_RTOL |J| |e| + F32_FLOOR
     |J| (the edge's translation scale), or no farther from it than twice
     the plain version in float32 is; two launches bit-equal;
     epnp_hypotheses and horn_hypotheses (by hypotheses, points, and for
     Horn fix_scale) against their plain versions (EPnP with the kernel's
     rule for the eigensolver's choices, canonical=True; EPnP solves in
     float64, Horn in float32) (ops/ransac_kernels.hypotheses_held): the
     degenerate samples NaN with no inliers in both, the counts equal on
     >= 90% of the hypotheses, the poses within 5e-4 on the well-posed
     samples (where the plain version solved in float32 and in float64
     agree within 2.5e-4); epnp_refine and horn_refine (by points) within
     1e-4 (R, t, s of itself) or, ill-conditioned, twice the plain
     version's own float32 gap, >= 99% of the inlier flags (refine_held);
     sim3_opt (by pairs, fix_scale, iterations) within 1e-4 (R, t, s of
     itself) and >= 99% of the flags of optimize_sim3_ref; voc_transform
     (by descriptors and tree) bit-equal, also on a random full tree of k
     10 and depth 6 (1,111,111 nodes, ORBvoc's shape, its levels past the
     staged nodes read from global memory) from SEED; each two launches
     bit-equal;
10. determinism: two card runs of the mapping System on the small camera
   over 8 frames give byte-identical TUM and KF/MP/Match dumps, and two
   card runs of the human System (small camera, seed 3, 2 humans, masked,
   Camera.fps 3: three human BA solves in 10 frames) byte-identical TUM
   and KF/MP/Match/HMTraj/Motion dumps;
11. loop replay: the first loop phase 7 closed, replayed (compute_sim3 ->
   correct, essential graph and global BA included) from a deep copy of
   the loop closer taken when it ran: two card replays give byte-identical
   KF / MP / Match dumps; a CPU replay agrees on every keyframe within 2e-3
   (R) / 5e-3 m (t), tests/test_torch_loop_system.py's tolerance;
12. agreement: the mapping System on the small camera over 6 frames on the
   CPU (plain versions) and on the card: the same branches and keyframes,
   poses within 5 mm / 1e-3; the human System of phase 7 on the CPU and
   on the card: the same branches and trajectories, cameras within 1e-4
   m, and after the first human BA solve the joints with an inlier
   projection edge within 5e-3 m (the gaps of the other joints and at the
   end of the run are printed: PERF.md says why they are not held);
13. online, run after phase 8 among the path phases (System with
   is_offline=False: tracking in this thread on a high-priority CUDA
   stream, the mapping pass and loop closing in a worker thread, the
   human BA and the global BA in background threads, each worker on its
   own stream of priority 0), every frame fed back to back:
   a. the pillar orbit of phase 7 with frame i + 1 prefetched before
      frame i, fed back to back and then again live at Camera.fps, each
      run held to the same checks: the last frame OK, a loop closed, the global BA run in its
      thread, ATE < 0.15 m, and tests/test_loop_stall.py's bound (the
      worst tracking frame stamped within [t_loop - 8 s, t_loop + 2 s],
      frames before 20 left out, below max(3 x median, median + 0.5 s));
      prints the tracking thread's per-frame median and p90 beside phase
      7's, the mapping load (keyframes inserted and refused, and the
      longest mapping queue, over the run and in the stall window, beside
      phase 7's keyframes), what the tracking thread waited for on the
      map lock in the stall window's worst frame and which worker
      sections held it meanwhile, the worker's spans and the launches by
      (kernel, thread, stream priority), and fails unless the mapping
      worker's epipolar and fuse-mode match_rows, triangulate and
      segment_sum launches, the essential graph's sim3_edges (in the
      mapping worker) and the global BA's schur_point and schur_camera
      (in its thread) went to a stream of lower priority than the
      tracking thread's match_rows launches;
   b. the crowd flagship of phase 5 online (tests/test_online_human.py):
      >= 2 human BA solves through HumanLocalBA.launch, a trajectory
      optimized, ATE < 0.03 m, nothing raised at shutdown;
   c. the API on the static frames: localization-only mode for frames
      18-27 after 18 mapped frames (no new keyframe or point, every frame
      OK, the last pose within 0.5 m: tests/test_config_flags.py), reset
      and re-initialization twice, the second reset issued while a global
      BA runs, and a prefetched frame bit-equal to the plain upload;
14. drivers, run after phase 13 among the path phases: the dataset
   drivers (python -m airdos_tpu_torch.examples.*) on sequences written
   with the port's PNG writer from the rendered frames quantized to uint8,
   through reference-format settings YAMLs that read back as the phases'
   configurations; every frame read back equal to what was written:
   a. KITTI layout, static-28: stereo_kitti as a subprocess (started
      once static-28 has rendered, so that it overlaps the other scenes'
      rendering; exit 0, 28 KITTI lines) and its main() in this process,
      both byte-identical to phase 4's System, which is fed the same
      uint8 frames as float32 (the in-memory twin);
   b. TartanAir layout, crowd-27 with segmentation, AlphaPose detections,
      track ids and times.txt: stereo_human with a SaveMap dump, its TUM
      byte-identical to phase 5's flagship on the same uint8 frames, the
      five SaveMap files written, ATE < 0.03 m;
   c. EuRoC layout, static-28 frames 0-13, identity rectification:
      stereo_euroc's TUM byte-identical to the in-memory System's; one
      frame rectified with the reference EuRoC.yaml's cam0 distortion;
      the host's PNG decode (Sub- and Paeth-filtered rows) and
      rectification times per 640x360 image;
   d. tools/evaluate on b's TUM against the ground truth as TUM: its ATE
      within 1e-6 m of this script's;
   e. System(use_viewer=True) over 6 static frames keeping overlays, one
      PPM overlay written (chiprun_out/drivers_overlay.ppm);
   prints each driver's per-frame tracking median and p90 and launches;
15. long horizon, run after phase 14 among the path phases:
   tests/test_long_horizon_dynamic.py on the card (110 frames, the small
   camera, seed 2, 10 humans in a crowd the camera drives through), the
   flagship and the naive static run: the flagship OK at the end, ATE <
   0.8 x the naive run's and < 0.05 m, >= 4 trajectories with >= 1
   ending early and >= 1 starting late, and over the optimized long
   trajectories the medians of joint error < 0.5 m, velocity error < 0.6
   and limb-length error < 0.15 m;
16. multi-device, run after phase 15 among the path phases: airdos_tpu's
   Device.NChips paths (parallel/sharded_ba.py) on a mesh of 4 ranks:
   real cards when the machine has two or more (as many as it has, up to
   4), else 4 virtual ranks on cuda:0 (AIRDOS_TORCH_VIRTUAL_DEVICES=4, set
   for this phase only); it prints which mesh it ran and each sub-step's
   time.  Every sharded run counts 45 segment_sum launches a local BA
   solve, 60 a human BA solve and 4 a global BA step on each rank's
   thread, and a global BA step 48 schur_point and 48 schur_camera
   launches in their raw mode (the shard's sums, psummed; Hpp^-1 and the
   CG update eager on every rank; 8 each in g's dry run):
   a. the first static BA problem phase 4 solved, sharded: within
      tests/test_sharded_ba.py's tolerances of the single-device solve (R
      2e-4, t 2e-3 m, inlier agreement > 0.98), two runs bit-equal;
   b. phase 4's System with Device.NChips = 4: every frame OK, >= 5
      keyframes, ATE < 0.02 m, every static BA solve sharded; its ATE
      beside phase 4's;
   c. phase 5's flagship with Device.NChips = 4: every frame OK, a
      sharded human BA at every cadence tick, ATE < 0.03 m, beside
      phase 5's;
   d. phase 8's global BA sharded: chi2 cut a hundredfold, every free
      keyframe moved, two runs bit-equal; the largest gap to phase 8's
      single-device solve and the solve times;
   e. phase 6's blackout with Device.NChips = 4: relocalized through the
      sharded EPnP RANSAC at phase 6's frame, an epnp_hypotheses and an
      epnp_refine launch a rank a RANSAC;
   f. the Sim3 RANSAC of phase 7's first closed loop, sharded: equal to
      sim3_ransac, a horn_hypotheses and a horn_refine launch a rank;
   g. airdos_tpu_torch.graft_entry.dryrun_multichip(4) on the card.

Each path's kernel launch counts are set to 0 just before the path is
driven and read just after; launches made to compare a kernel with its
plain version are not counted, nor the single-device solve that
sub-step 16a compares with, nor 16f's single-device RANSAC; the kernels
line's launches add up the mapping, human, reloc, loop, map-scale,
online, drivers, long-horizon and multi-device paths' counts.  Over all
the paths, every triangulation call launches one epipolar match_rows and
one triangulate, every relocalization RANSAC one epnp_hypotheses and one
epnp_refine, every Sim3 RANSAC one horn_hypotheses and one horn_refine,
every OptimizeSim3 one sim3_opt and every Vocabulary.transform one
voc_transform (each counted on its calling thread), and no path launches
the Hamming kernel (2-D or batched); 16e launches the EPnP modes and 16f
the Horn modes once a rank a RANSAC.  Frames are
rendered in a pool of forked processes before any CUDA context exists.
The last lines are one JSON line listing the kernels, the nvidia-smi
line, and {"ok": true, "device": {...}}.
Exits non-zero, printing no result, on any failure, including when no
CUDA device is present.

With --profile, phases 1-2 run and then phase_profile instead of the rest:
synchronized stage timers over the 28 bench frames (tracking stages per
fused frame, triangulation (its _assemble, triangulate_pair with its
epipolar match_rows and triangulate launches, and write-back) / fusion /
BA solve per keyframe) and a
torch.profiler trace of each of the last four frames (its device kernel
count and each port kernel's launches), relocalization's and
ComputeSim3's stages (geometry_split: the relocalizing frame of phase 6's
blackout and pillar-84's ComputeSim3 calls, each stage synchronized with
its launches, the frame's and each ComputeSim3's device busy time), then
the crowd-27 flagship run's human BA stages (assembly, solve, write-back)
and one more solve of its last window under torch.profiler (device busy
time and the kernels that hold it); it checks nothing and prints no
result line.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import io
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np

N_FRAMES = 28
N_CROWD = 27          # bench.py sections 2-3: 7 warm-up + 20 timed frames
N_ORBIT = 84          # tests/test_loop_closure.py's pillar orbit
N_LONG = 110          # tests/test_long_horizon_dynamic.py's crowd
N_GOOD, N_BLANK, N_HOLD = 18, 3, 5    # the relocalization blackout
SEED = 0
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
# kernel name -> {shape: [launches, first inputs]} on the main paths
_PATH: dict = {}
# (B, N1, N2) -> the first triangulate_pair inputs the paths gave
_FOR_TRI: dict = {}
# what the single-device phases leave for phase multi-device: the first
# static BA problem and the ATE of phase mapping, the ATE of phase human,
# the relocalizing frame of phase reloc, the Sim3 RANSAC inputs of phase
# loop's first closed loop, and the map-scale problem and solution
_FOR_MESH: dict = {}
# the render job the pool's forked workers read
_RENDER: dict = {}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        _fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Milliseconds per call of fn(), warm: the median over reps samples of
    the CUDA-event time of inner back-to-back calls, divided by inner (5
    samples of 2 calls for a call over 2 ms: the plain versions and
    library calls at the batched shapes).  A call whose host side outlasts
    its device work is timed by the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 2e-3:
        reps, inner = 5, 2
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _graph_ms(fn, n: int = 100, reps: int = 15):
    """Device ms per call of fn, from CUDA events around replays of a
    CUDA graph of n calls (no host launch cost between them): (cold,
    hot).  Cold: each call after a 64 MB write that evicts the 50 MB L2,
    as a caller that streams its inputs from HBM finds them; the graph of
    the writes alone is timed alike and taken off.  Hot: n calls back to
    back, the inputs left in L2.  Medians of reps replays."""
    import torch
    flush = torch.empty(16 * 2 ** 20, dtype=torch.int32, device="cuda")

    def per_call(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up before capture
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                body()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / n)
        del graph
        return statistics.median(times)

    flush_ms = per_call(flush.zero_)
    cold = per_call(lambda: (flush.zero_(), fn())) - flush_ms
    return cold, per_call(fn)


def _device_ms(fn, kernel: str = "", reps: int = 20):
    """Mean device time (ms) per call of the kernels whose name holds
    `kernel` (all of fn's kernels by default) over reps calls of fn(),
    from torch.profiler's CUDA trace; None when the trace holds no such
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and kernel in e.name]
    if not evs:
        return None
    return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3


def _hamming():
    from airdos_tpu_torch.ops import hamming_kernels as hk
    return hk


def _segments():
    from airdos_tpu_torch.ops import segment_kernels as sk
    return sk


def _pose():
    from airdos_tpu_torch.solvers import pose_opt as po
    return po


def _fast():
    from airdos_tpu_torch.ops import fast as fk
    return fk


def _orb():
    from airdos_tpu_torch.ops import orb_kernels as ok
    return ok


def _pyr():
    from airdos_tpu_torch.ops import pyramid as pk
    return pk


def _sel():
    from airdos_tpu_torch.ops import select as sk
    return sk


def _sad():
    from airdos_tpu_torch.ops import stereo_sad as ss
    return ss


def _disp():
    from airdos_tpu_torch.ops import disparity as dk
    return dk


def _bst():
    from airdos_tpu_torch.ops import ba_static as bs
    return bs


def _bpt():
    from airdos_tpu_torch.ops import ba_points as bp
    return bp


def _bhu():
    from airdos_tpu_torch.ops import ba_human as bh
    return bh


def _match():
    from airdos_tpu_torch.ops import match_kernels as mk
    return mk


def _tri():
    from airdos_tpu_torch.ops import triangulate_kernels as tk
    return tk


def _bgl():
    from airdos_tpu_torch.ops import ba_global as bg
    return bg


def _pgk():
    from airdos_tpu_torch.ops import pose_graph_kernels as pk
    return pk


def _rsk():
    from airdos_tpu_torch.ops import ransac_kernels as rk
    return rk


def _s3o():
    from airdos_tpu_torch.ops import sim3_opt_kernels as so
    return so


def _voc():
    from airdos_tpu_torch.ops import voc_kernels as vk
    return vk


# the modules that hold the kernels, one nvcc source each
_MODULES = (_hamming, _segments, _pose, _fast, _orb, _pyr, _sel, _sad, _disp,
            _bst, _bpt, _bhu, _match, _tri, _bgl, _pgk, _rsk, _s3o, _voc)


def _words(rng, shape):
    import torch
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).cuda()


def _unpack_bits(w):
    """int32 descriptor words [..., 8] -> float32 {0, 1} [..., 256]."""
    import torch
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    return ((w[..., None] >> shifts) & 1).flatten(-2).to(torch.float32)


# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 rate, the int8
# tensor-core rate (the table lists no binary rate; a 1-bit AND + popcount
# is counted as two operations against it) and float32 outside the tensor
# cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS = 67e12
# float64 outside the tensor cores (NVIDIA's data sheet: 34 TFLOP/s; the
# 67 TFLOP/s of float64 are the tensor cores'), the BA kernels' sums
FP64_FLOPS = 34e12


# ------------------------------------------------------------- Hamming

def _ham_shape(a, b):             # (batch of a, batch of b, n, m)
    return (1, 1) + tuple(a.shape[:1]) + tuple(b.shape[:1])


def _batched_shape(a, b):
    return tuple(a.shape[:1]) + tuple(b.shape[:1]) + \
        tuple(a.shape[1:2]) + tuple(b.shape[1:2])


def _ham_fmt(shape) -> str:
    return f"{shape[2]}x{shape[3]}"


def _batched_fmt(shape) -> str:
    ba, bb, n, m = shape
    return f"B={max(ba, bb)} x {n}x{m} (a {'shared' if ba == 1 else ba})"


def _ham_out(shape) -> int:
    return max(shape[0], shape[1]) * shape[2] * shape[3]


def _ham_check(batched: bool):
    def check(args):
        import torch
        hk = _hamming()
        name, kernel, plain = (
            ("hamming_matrix_batched", hk.hamming_matrix_batched,
             hk.hamming_matrix_batched_ref) if batched else
            ("hamming_matrix", hk.hamming_matrix, hk.hamming_matrix_ref))
        a, b = args
        got, want = kernel(a, b), plain(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            _fail(f"{name} != plain version (max abs err {err})")
        return err, "exact", (lambda: kernel(a, b)), (lambda: plain(a, b))
    return check


def _ham_bound(shape, args):
    """Both descriptor sets read once, the distances written once; a
    1-bit AND + popcount a bit pair at the int8 tensor-core rate."""
    ba, bb, n, m = shape
    return (32 * (ba * n + bb * m) + 4 * max(ba, bb) * n * m,
            2 * 256 * max(ba, bb) * n * m / INT8_OPS_PER_S)


def _ham_variants(batched: bool):
    """No path launches the Hamming kernel since triangulation's epipolar
    search and the loop's Sim3 match run on match_rows: the descriptors of
    the largest epipolar match_rows call the paths recorded (triangulation:
    the keyframe's rows against its neighbours', B = 4 x 1536 x 1536 at the
    bench budget; the 2-D kernel against the first neighbour's), or 1536 x
    1536 random words where none was recorded."""
    def variants(shapes):
        import torch
        mk = _match()
        epi = [a for sh, (n, a) in _PATH.get("match_rows", {}).items()
               if sh[0] == mk.EPIPOLAR]
        if epi:
            rows, cols = max(epi, key=lambda a: a[2].desc.numel())[1:3]
            a, b = rows.desc, cols.desc
        else:
            rng = np.random.default_rng(SEED)
            a, b = _words(rng, (1536, 8)), _words(rng, (4, 1536, 8))
        args = (a[None], b) if batched else (a, b[0].contiguous())
        key = (_batched_shape if batched else _ham_shape)(*args)
        return {key: args}
    return variants


def _ham_library(args):
    """torch.cdist(p=0), the count of differing bits, on the unpacked
    descriptors."""
    import torch
    a, b = args
    if a.dim() == 2:
        x, y = _unpack_bits(a), _unpack_bits(b)
    else:
        B = max(a.shape[0], b.shape[0])
        x = _unpack_bits(a).expand(B, -1, -1).contiguous()
        y = _unpack_bits(b).expand(B, -1, -1).contiguous()
    return (lambda: torch.cdist(x, y, p=0)), "cdist(p=0)"


# --------------------------------------------------------- segment_sum

def _seg_shape(vals, seg):        # (rows, columns, segments)
    return tuple(vals.shape) + (seg.n,)


def _seg_fmt(shape) -> str:
    rows, k, n = shape
    return f"{rows} rows -> {n} x {k}"


def _seg_check(args):
    import torch
    sk = _segments()
    vals, seg = args
    got1 = sk.segment_sum(vals, seg)
    got2 = sk.segment_sum(vals, seg)
    want = sk.segment_sum_ref(vals.cpu(), seg.key.cpu(), seg.n)
    torch.cuda.synchronize()
    err = float((got1.cpu() - want).abs().max())
    if not torch.equal(got1.cpu(), want):
        _fail(f"segment_sum != plain version on the CPU (max abs err {err})")
    if not torch.equal(got1, got2):
        _fail("segment_sum launches differ")
    longest = int(seg.offsets.diff().max())
    what = (f"bit-equal to the CPU plain version, deterministic; longest "
            f"segment {longest} rows")
    return err, what, (lambda: sk.segment_sum(vals, seg)), \
        (lambda: sk.segment_sum_ref(vals, seg.key, seg.n))


def _seg_bound(shape, args):
    """Only the rows its segments hold (this run's data) are read."""
    rows, k, n = shape
    kept = int(args[1].offsets[-1])
    return 4 * (kept * (k + 1) + (n + 1) + n * k), kept * k / FP32_FLOPS


def _seg_library(args):
    """index_add_ into a preallocated buffer (the rows keyed n land in its
    last row)."""
    import torch
    vals, seg = args
    acc = torch.zeros((seg.n + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return (lambda: acc.index_add_(0, seg.key, vals)), "index_add_"


# float32 operations per unit of work, counted from the kernels' code: a
# pose LM build pass over one active edge (projection 32, Jacobian 24,
# chi2 and Huber 14, weights 19, H's 21 terms 126, b's 6 terms 36, cost
# and count 2), a classification pass over one edge, one serial LM step
# (prior, damping, the 6x6 Schur inverse, se3_exp, compose), one
# interior pixel's FAST score with its mask and threshold (16
# differences, the 16 arcs' minima and maxima from prefix and suffix
# extrema over blocks of 9: 2 x 45, 2 x 15 over the arcs, 5), one
# pixel's NMS, and one keypoint's IC moments (4 a disc pixel) plus its
# 512 rotated samples (6 each), 256 comparisons and transcendentals
POSE_BUILD_FLOPS = 253
POSE_CLASSIFY_FLOPS = 40
POSE_STEP_FLOPS = 800
FAST_PIXEL_FLOPS = 141
NMS_PIXEL_FLOPS = 9
ORB_SAMPLE_FLOPS = 6
ORB_EXTRA_FLOPS = 256 + 100


def _no_library(args):
    return None, "none"            # no single PyTorch call computes it


# ------------------------------------------------------------- pose LM

# the pose LM kernel against its plain version: tests/test_torch_pose.py's
# tolerances (the block sums in another order than torch's reductions)
POSE_R_TOL = POSE_T_TOL = 1e-4
POSE_INLIER_SHARE = 0.99


def _pose_shape(pose0, edges, scalars):   # (edges, prior on)
    return (edges.shape[0], scalars[7] > 0 or scalars[8] > 0)


def _pose_fmt(shape) -> str:
    n, prior = shape
    return f"N={n} edges, prior {'on' if prior else 'off'}"


def _pose_check(args):
    import torch
    po = _pose()
    got, again = po.pose_lm_cuda(*args), po.pose_lm_cuda(*args)
    want = po.pose_lm_ref(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        _fail("pose_lm: two launches differ")
    err_R = float(torch.linalg.norm(got.R - want.R))
    err_t = float((got.t - want.t).abs().max())
    same = float((got.inlier == want.inlier).float().mean()) \
        if got.inlier.numel() else 1.0
    if not (err_R <= POSE_R_TOL and err_t <= POSE_T_TOL
            and same >= POSE_INLIER_SHARE):
        _fail(f"pose_lm != plain version: R {err_R}, t {err_t} m, "
              f"inlier flags equal {same}")
    if int(got.n_inliers) != int(got.inlier.sum()):
        _fail(f"pose_lm: inlier count {int(got.n_inliers)} != "
              f"{int(got.inlier.sum())} flags")
    err = max(float((got.R - want.R).abs().max()), err_t)
    what = (f"R {err_R:.2e} (Frobenius), t {err_t:.2e} m, inlier flags "
            f"equal {same:.4f} ({int(got.n_inliers)} inliers), two "
            f"launches bit-equal")
    return err, what, (lambda: po.pose_lm_cuda(*args)), \
        (lambda: po.pose_lm_ref(*args))


def _pose_bound(shape, args):
    """The edges active in each of this call's build passes, as the kernel
    reports them."""
    import torch
    n = shape[0]
    out, _ = _pose().pose_lm_launch(*args)
    work = int(out[13:14].view(torch.int32).item())  # active edge-passes
    nbytes = 29 * n + 48 + n + 56     # xw, obs, 1/sigma^2, valid, pose
    ops = (work * POSE_BUILD_FLOPS + 5 * n * POSE_CLASSIFY_FLOPS
           + 44 * POSE_STEP_FLOPS)
    return nbytes, ops / FP32_FLOPS


# ------------------------------------------------------------ FAST + NMS

def _fast_shape(images, masks, min_th, border):   # the level shapes
    return tuple(tuple(im.shape) for im in images)


def _fast_fmt(shape) -> str:
    return (f"{len(shape)} levels {shape[0][0]}x{shape[0][1]} to "
            f"{shape[-1][0]}x{shape[-1][1]}")


def _fast_check(args):
    """The all-levels launch against the plain version and against the
    per-level launches of the same kernel (the launch-a-level design), which
    it equals bit for bit; two launches bit-equal; the per-level launches'
    device time beside it."""
    import torch
    fk = _fast()
    images, masks, min_th, border = args

    def per_level():
        return [fk.fast_nms_cuda(im, m, min_th, border)
                for im, m in zip(images, masks)]
    got, again = fk.fast_nms_levels_cuda(*args), fk.fast_nms_levels_cuda(*args)
    per, want = per_level(), fk.fast_nms_levels_ref(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    for lvl, (a, b, c, d) in enumerate(zip(got, again, per, want)):
        if not torch.equal(a, d):
            _fail(f"fast_nms level {lvl} != plain version (max abs err {err})")
        if not torch.equal(a, b):
            _fail(f"fast_nms level {lvl}: two launches differ")
        if not torch.equal(a, c):
            _fail(f"fast_nms level {lvl}: the all-levels launch differs from "
                  f"the per-level launch")
    cold, hot = _graph_ms(per_level)
    what = (f"bit-equal to the plain version and to the per-level launches, "
            f"two launches bit-equal, {sum(int((m > 0).sum()) for m in got)} "
            f"corners kept; the {len(images)} per-level launches (the "
            f"launch-a-level design): device time (CUDA graph) L2 cold {cold:.4f} ms, hot "
            f"{hot:.4f} ms")
    return err, what, (lambda: fk.fast_nms_levels_cuda(*args)), \
        (lambda: fk.fast_nms_levels_ref(*args))


def _fast_bound(shape, args):
    """Over the levels: each level's image and mask read once and its map
    written once."""
    border = args[3]
    nbytes = ops = 0
    for h, w in shape:
        inside = max(0, h - 2 * border) * max(0, w - 2 * border)
        nbytes += 12 * h * w
        ops += inside * FAST_PIXEL_FLOPS + h * w * NMS_PIXEL_FLOPS
    return nbytes, ops / FP32_FLOPS


# ------------------------------------------------------------ orb_desc

# rBRIEF descriptors held bit-equal unless the moments round (ops/
# orb_kernels.py) or a transcendental differs, then to this share of
# equal descriptors; angles within this many degrees
DESC_SHARE = 0.999
ANGLE_TOL_DEG = 1e-3


def _orb_shape(images, blurred, xs, ys, quotas):   # (level shapes, quotas)
    return (tuple(tuple(im.shape) for im in images), tuple(quotas))


def _orb_fmt(shape) -> str:
    shapes, quotas = shape
    return (f"{len(shapes)} levels {shapes[0][0]}x{shapes[0][1]} to "
            f"{shapes[-1][0]}x{shapes[-1][1]}, {sum(quotas)} slots "
            f"({quotas[0]} at level 0)")


def _orb_check(args):
    """The all-levels launch against the plain version and against the
    per-level launches of the same kernel (PR 9's launch a level), which
    it equals bit for bit; two launches bit-equal."""
    import torch
    ok = _orb()
    images, blurred, xs, ys, quotas = args
    ang, words = ok.orb_describe_levels_cuda(*args)
    ang2, words2 = ok.orb_describe_levels_cuda(*args)
    per = [ok.orb_describe_cuda(im, bl, xs[f:f + q], ys[f:f + q])
           for im, bl, f, q in zip(images, blurred, ok.level_table(quotas),
                                   quotas)]
    want_ang, want_words = ok.orb_describe_levels_ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(ang, ang2) or not torch.equal(words, words2):
        _fail("orb_desc: two launches differ")
    if not torch.equal(ang, torch.cat([a for a, _ in per])) or \
            not torch.equal(words, torch.cat([d for _, d in per])):
        _fail("orb_desc: the all-levels launch differs from the per-level "
              "launches")
    gap = (ang.double() - want_ang.double()).abs() % 360.0
    err = float(torch.minimum(gap, 360.0 - gap).max()) if ang.numel() else 0.0
    n_ang = int((ang.view(torch.int32) != want_ang.view(torch.int32)).sum())
    n_words = int((words != want_words).sum())
    share = float((words == want_words).all(dim=1).float().mean()) \
        if words.shape[0] else 1.0
    if err > ANGLE_TOL_DEG or share < DESC_SHARE:
        _fail(f"orb_desc != plain version: angles max err {err} deg ({n_ang} "
              f"differ), descriptors equal {share} ({n_words} words differ)")
    what = ("angles and descriptors bit-equal" if n_ang == 0 and n_words == 0
            else f"{n_ang} angles differ (max {err:.2e} deg), {n_words} "
                 f"words differ, descriptors equal {share:.4f}")
    what += "; equal to the per-level launches"
    return err, what, (lambda: ok.orb_describe_levels_cuda(*args)), \
        (lambda: ok.orb_describe_levels_ref(*args))


def _orb_bound(shape, args):
    """Over the levels: the distinct pixels each level's keypoints' discs
    and samples touch (its float64 moment sums counted at the float32
    rate)."""
    import torch
    from airdos_tpu_torch.ops.orientation import _umax
    ok = _orb()
    images, blurred, xs, ys, quotas = args
    u = _umax()
    disc = torch.tensor([(dy, dx) for dy in range(-15, 16)
                         for dx in range(-u[abs(dy)], u[abs(dy)] + 1)],
                        device=xs.device)
    n_disc = disc.shape[0]
    ang, _ = ok.orb_describe_levels_cuda(*args)
    pts = ok.pattern_points(xs.device)
    nbytes = ops = 0
    for img, f, q in zip(images, ok.level_table(quotas), quotas):
        if q == 0:
            continue
        h, w = img.shape
        x, y = xs[f:f + q], ys[f:f + q]
        gy = (y[:, None] + disc[None, :, 0]).clamp(0, h - 1)
        gx = (x[:, None] + disc[None, :, 1]).clamp(0, w - 1)
        disc_px = torch.unique(gy * w + gx).numel()
        r = torch.deg2rad(ang[f:f + q])[:, None]
        c, sn = torch.cos(r), torch.sin(r)
        sx = torch.round(pts[0] * c - pts[1] * sn).to(torch.int64)
        sy = torch.round(pts[0] * sn + pts[1] * c).to(torch.int64)
        sample_px = torch.unique((y[:, None] + sy).clamp(0, h - 1) * w
                                 + (x[:, None] + sx).clamp(0, w - 1)).numel()
        nbytes += 4 * (disc_px + sample_px) + 16 * q + 36 * q
        ops += q * (4 * n_disc + 512 * ORB_SAMPLE_FLOPS + ORB_EXTRA_FLOPS)
    return nbytes, ops / FP32_FLOPS


# ------------------------------------------------------------- pyramid

# float32 operations an output pixel, counted from csrc/pyramid.cu: the
# blur's 7 products and 6 sums in each direction; a bilinear value's 6
# products and 3 sums, twice (image and mask) with the threshold; the
# erosion's 9 + 9 minima
PYR_BLUR_FLOPS = 26
PYR_RESIZE_FLOPS = 19
PYR_ERODE_FLOPS = 18


def _pyr_shape(img, mask, n_levels, scale_factor, mask_erode):
    # (h, w, levels, scale factor, mask dtype, erosion window)
    return tuple(img.shape) + (n_levels, scale_factor, None if mask is None
                               else str(mask.dtype).split(".")[-1],
                               mask_erode)


def _pyr_fmt(shape) -> str:
    h, w, n, _, mask, k = shape
    return (f"{n} levels from {h}x{w} (mask {mask or 'none'}"
            f"{f', erosion {k}' if mask else ''})")


def _pyr_levels(args, launch):
    """The levels of build_pyramid_cuda(*args) a level at a time, each
    from the one before: [(image, mask, blur)] by launch(src, src_mask,
    h, w, level0, mask_erode), the one-level kernel (the launch-a-level
    design) or the plain version."""
    img, mask, n, factor, erode_k = args
    shapes = _pyr().level_shapes(*img.shape, n, factor)
    out = [launch(img, mask, *shapes[0], True, erode_k)]
    for h, w in shapes[1:]:
        out.append(launch(out[-1][0], out[-1][1], h, w, False, erode_k))
    return out


def _pyr_check(args):
    """The cooperative launch against the plain version and the
    per-level launches of the one-level kernel, which it equals bit for
    bit; two launches bit-equal; its grid and barriers, and the per-level
    launches' device time beside it."""
    import torch
    pk = _pyr()
    img, mask, n, factor, _ = args

    def per_level():
        return _pyr_levels(args, pk.pyramid_level_cuda)
    got, again = pk.build_pyramid_cuda(*args), pk.build_pyramid_cuda(*args)
    per, want = per_level(), _pyr_levels(args, pk.pyramid_level_ref)
    torch.cuda.synchronize()
    err = 0.0
    for lvl in range(n):
        for part, name in enumerate(("image", "mask", "blur")):
            a, b = got[part][lvl], again[part][lvl]
            c, d = per[lvl][part], want[lvl][part]
            err = max(err, float((a - d).abs().max()))
            if not torch.equal(a, d):
                _fail(f"pyramid level {lvl} {name} != plain version (max abs "
                      f"err {err})")
            if not torch.equal(a, b):
                _fail(f"pyramid level {lvl} {name}: two launches differ")
            if not torch.equal(a, c):
                _fail(f"pyramid level {lvl} {name}: the cooperative launch "
                      f"differs from the per-level launches")
    shapes = pk.level_shapes(*img.shape, n, factor)
    _, sms, per_sm = pk.residency(img.device)
    cold, hot = _graph_ms(per_level)
    what = (f"images, masks and blurs bit-equal to the plain version and to "
            f"the per-level launches, two launches bit-equal, "
            f"{int(got.masks[0].sum())} usable pixels at level 0; "
            f"cooperative grid {pk.cooperative_grid(img.device, shapes)} "
            f"blocks ({sms} SMs, {per_sm} resident an SM), {n - 1} grid "
            f"barriers; the {n} per-level launches (the launch-a-level "
            f"design): device "
            f"time (CUDA graph) L2 cold {cold:.4f} ms, hot {hot:.4f} ms")
    return err, what, (lambda: pk.build_pyramid_cuda(*args)), \
        (lambda: _pyr_levels(args, pk.pyramid_level_ref))


def _pyr_bound(shape, args):
    """The input image and its mask read once, every level's outputs
    written once (level 0 writes no image: it is the input); the levels a
    phase reads back are the launch's own."""
    h, w, n, factor, mask, _ = shape
    levels = _pyr().level_shapes(h, w, n, factor)[1:]
    mask_bytes = {None: 0, "uint8": 1, "float32": 4}[mask]
    nbytes = (4 + mask_bytes + 8) * h * w + sum(12 * a * b for a, b in levels)
    ops = h * w * (PYR_BLUR_FLOPS + (PYR_ERODE_FLOPS if mask else 0)) + sum(
        a * b * (PYR_BLUR_FLOPS + PYR_RESIZE_FLOPS) for a, b in levels)
    return nbytes, ops / FP32_FLOPS


def _pyr_variants(cases):
    """The mask kinds the paths did not launch at an image size they
    launched with a uint8 mask: that mask as float32, and no mask."""
    out = {}
    for _, args in cases.values():
        img, mask, n, factor, erode_k = args
        if mask is None or str(mask.dtype) != "torch.uint8":
            continue
        for other in (mask.float(), None):
            alt = (img, other, n, factor, erode_k)
            key = _pyr_shape(*alt)
            if key not in cases:
                out.setdefault(key, alt)
    return out


# ------------------------------------------------------------- select

def _sel_shape(maps, quotas, cells, ini_th):   # (level shapes, quotas)
    return tuple(tuple(s.shape) for s in maps), tuple(quotas)


def _sel_fmt(shape) -> str:
    levels, quotas = shape
    return (f"{len(levels)} levels {levels[0][0]}x{levels[0][1]} to "
            f"{levels[-1][0]}x{levels[-1][1]}, {sum(quotas)} slots")


def _sel_check(args):
    import torch
    sk = _sel()
    got, again = sk.select_keypoints_cuda(*args), \
        sk.select_keypoints_cuda(*args)
    want = sk.select_keypoints_ref(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    for name, a, b, c in zip(("xs", "ys", "response"), got, again, want):
        if not torch.equal(a, c) or not torch.equal(a, b):
            _fail(f"select {name} != plain version (max abs err {err})")
    what = f"xs, ys and responses bit-equal, {int((got[2] > 0).sum())} kept"
    return err, what, (lambda: sk.select_keypoints_cuda(*args)), \
        (lambda: sk.select_keypoints_ref(*args))


def _sel_bound(shape, args):
    """The maps read once, 20 bytes a slot written; a comparison and a
    boost a pixel, and the bitonic sort's comparisons of each level's
    cells (rounded up to a power of two)."""
    levels, quotas = shape
    cells = args[2]
    px = sum(h * w for h, w in levels)
    sort = 0
    for (h, w), c in zip(levels, cells):
        p = 1
        while p < -(-h // c) * -(-w // c):
            p <<= 1
        k = p.bit_length() - 1
        sort += p // 2 * k * (k + 1) // 2
    return 4 * px + 20 * sum(quotas), (2 * px + sort) / FP32_FLOPS


# ------------------------------------------------------------ stereo_sad

# the stereo refinement: bit-equal where the docstring's condition holds
# (every pixel 0 or >= 2^-8); else this share of equal accept flags and
# u_right within this many pixels where both accept
SAD_SHARE = 0.999
SAD_U_TOL = 1e-3
# float32 operations a keypoint: 121 + 11 x 121 centre subtractions, 1331
# differences, absolute values and (float64) sums, the parabola and tests
SAD_KEYPOINT_FLOPS = 121 + 4 * 1331 + 60


def _sad_shape(*args):                    # (keypoints, levels, h0, w0)
    levels = args[6]
    return (args[0].shape[0], len(levels)) + tuple(levels[0].shape)


def _sad_fmt(shape) -> str:
    n, n_levels, h0, w0 = shape
    return f"{n} keypoints, {n_levels} levels from {h0}x{w0}"


def _sad_exact_inputs(args) -> bool:
    """Every pixel of both images' levels 0 or at least 2^-8 in magnitude
    (ops/stereo_sad.py's condition for bit equality)."""
    return all(bool(((im == 0) | (im.abs() >= 2.0 ** -8)).all())
               for im in tuple(args[6]) + tuple(args[7]))


def _sad_check(args):
    import torch
    ss = _sad()
    got, again = ss.stereo_sad_cuda(*args), ss.stereo_sad_cuda(*args)
    want = ss.stereo_sad_ref(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        _fail("stereo_sad: two launches differ")
    both = got[3] & want[3]
    err = float((got[1] - want[1])[both].abs().max()) if bool(both.any()) \
        else 0.0
    n_diff = [int((a != b).sum()) for a, b in zip(got, want)]
    if _sad_exact_inputs(args):
        if any(n_diff):
            _fail(f"stereo_sad != plain version on inputs its condition "
                  f"holds for: differing best_sad, u_right, disparity, "
                  f"accept {n_diff}")
        what = (f"best_sad, u_right, disparity and accept bit-equal (every "
                f"pixel 0 or >= 2^-8), {int(got[3].sum())} accepted")
    else:
        share = float((got[3] == want[3]).float().mean())
        if share < SAD_SHARE or err > SAD_U_TOL:
            _fail(f"stereo_sad != plain version: accept flags equal {share}, "
                  f"u_right max err {err} px")
        what = (f"a pixel under 2^-8: accept flags equal {share:.4f}, "
                f"u_right within {err:.2e} px; differing best_sad, u_right, "
                f"disparity, accept {n_diff}")
    return err, what, (lambda: ss.stereo_sad_cuda(*args)), \
        (lambda: ss.stereo_sad_ref(*args))


def _window_pixels(levels, oct_, rows, cols) -> int:
    """Distinct pixels of the windows (level, row, column), each level's
    columns and rows clamped to level 0's extent as the kernels read."""
    import torch
    h0, w0 = levels[0].shape
    key = (oct_[:, None, None] * h0 + rows[:, :, None]) * w0 + cols[:, None, :]
    return int(torch.unique(key).numel())


def _sad_bound(shape, args):
    """The distinct window pixels of both images read once, 43 bytes a
    keypoint of inputs and outputs; SAD_KEYPOINT_FLOPS a keypoint."""
    import torch
    xy_l, oct_l, _, xy_r, best_r = args[:5]
    levels_l, scales = args[6], args[9]
    n = shape[0]
    h0, w0 = levels_l[0].shape
    inv = 1.0 / scales[oct_l]
    su = torch.round(xy_l[:, 0] * inv).to(torch.int64)
    sv = torch.round(xy_l[:, 1] * inv).to(torch.int64)
    sur = torch.round(xy_r[best_r, 0] * inv).to(torch.int64)
    off = torch.arange(-5, 6, device=su.device)
    offr = torch.arange(-10, 11, device=su.device)
    rows = (sv[:, None] + off).clamp(0, h0 - 1)
    px = _window_pixels(levels_l, oct_l, rows,
                        (su[:, None] + off).clamp(0, w0 - 1)) + \
        _window_pixels(levels_l, oct_l, rows,
                       (sur[:, None] + offr).clamp(0, w0 - 1))
    return 4 * px + 43 * n, n * SAD_KEYPOINT_FLOPS / FP32_FLOPS


# ------------------------------------------------------- patch_disparity

# float32 operations a probe: 48 x 121 differences, absolute values and
# (float64) sums, the penalty, the argmin and the parabola
DISP_PROBE_FLOPS = 3 * 48 * 121 + 48 + 60


def _disp_shape(im_left, im_right, px, num_disp=48, block=11):
    return tuple(im_left.shape) + (px.shape[0], num_disp, block)


def _disp_fmt(shape) -> str:
    h, w, n, d, b = shape
    return f"{h}x{w} images, {n} probes, {d} disparities, {b}x{b}"


def _disp_check(args):
    import torch
    dk = _disp()
    got, again = dk.patch_disparity_cuda(*args), dk.patch_disparity_cuda(*args)
    want = dk.patch_disparity_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want) or not torch.equal(got, again):
        _fail(f"patch_disparity != plain version (max abs err {err})")
    what = f"bit-equal, {int((got >= 0).sum())} of {got.numel()} valid"
    return err, what, (lambda: dk.patch_disparity_cuda(*args)), \
        (lambda: dk.patch_disparity_ref(*args))


def _disp_bound(shape, args):
    """The distinct patch and strip pixels read once, 12 bytes a probe;
    DISP_PROBE_FLOPS a probe."""
    import torch
    h, w, n, d, b = shape
    px = args[2]
    u = torch.round(px[:, 0]).to(torch.int64)
    v = torch.round(px[:, 1]).to(torch.int64)
    half = b // 2
    rows = (v[:, None] + torch.arange(-half, half + 1, device=u.device)) \
        .clamp(0, h - 1)
    zero = torch.zeros_like(u)
    left = _window_pixels(args[:1], zero, rows, (
        u[:, None] + torch.arange(-half, half + 1, device=u.device))
        .clamp(0, w - 1))
    right = _window_pixels(args[:1], zero, rows, (
        u[:, None] + torch.arange(-(d - 1) - half, half + 1,
                                  device=u.device)).clamp(0, w - 1))
    return 4 * (left + right) + 12 * n, n * DISP_PROBE_FLOPS / FP32_FLOPS


# ------------------------------------------------- the BAs' Gauss-Newton

def _bits_equal(a, b) -> bool:
    """Bit for bit (NaNs equal to NaNs, whatever their payload)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.contiguous(), b.contiguous()
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def _outs(x):
    """A kernel's outputs as a tuple of tensors."""
    return tuple(x) if isinstance(x, tuple) else (x,)


def _ba_check(name, cuda_fn, plain_fn):
    """Bit-equal to the plain version on the card, and two launches
    bit-equal to each other."""
    def check(args):
        import torch
        got = _outs(cuda_fn()(*args))
        again = _outs(cuda_fn()(*args))
        want = _outs(plain_fn()(*args))
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(got, want):
            ok = torch.isfinite(a) & torch.isfinite(b)
            if ok.any():
                err = max(err, float((a[ok] - b[ok]).abs().max()))
        if not all(_bits_equal(a, b) for a, b in zip(got, want)):
            _fail(f"{name} != plain version (max abs err {err})")
        if not all(_bits_equal(a, b) for a, b in zip(got, again)):
            _fail(f"{name}: two launches differ")
        n = sum(int((~torch.isfinite(a)).sum()) for a in got)
        what = f"bit-equal, deterministic, {n} non-finite outputs"
        return err, what, (lambda: cuda_fn()(*args)), \
            (lambda: plain_fn()(*args))
    return check


# float32 and float64 operations a unit of work, counted from the kernels'
# code: a static edge's projection, chi2, Huber and weight (float32) and
# its three normal-equation rows (float64; cost mode: the float32 part);
# a landmark's damped float64 inverse and an Aagg row (3 x 5); a
# back-substitution camera (18 products, 18 sums) and a point's tree and
# step; a human edge of each family (float32) and its column entries
# (float64)
STATIC_EDGE_F32, STATIC_EDGE_F64 = 102, 432
POINT_INVERSE_F64, AAGG_ROW_F64 = 53, 15
BACKSUB_CAMERA_F64, BACKSUB_POINT_F64 = 36, 30
HUMAN_F32 = (93, 20, 30)
HUMAN_F64 = (504, 70, 852)


def _st_shape(R, t, pts, e_cam, *rest):     # (edges, C, P, mode)
    return (e_cam.shape[0], R.shape[0], pts.shape[0], int(rest[-1]))


_ST_MODES = ("Gauss-Newton", "cost", "cost-sum")


def _st_fmt(shape) -> str:
    E, C, P, mode = shape
    return f"E={E} C={C} P={P}, {_ST_MODES[mode]} mode"


def _st_bound(shape, args):
    """The cameras, points and the edge table read once (active in
    Gauss-Newton and cost-sum modes), the rows (72 floats an edge), the
    costs (3) or the sum (one float) written once; the cost sum's guard,
    product and add at the float32 rate."""
    E, C, P, mode = shape
    edges = 48 * C + 12 * P + E * (24 + (0 if mode == 1 else 4))
    out = (4 * E * 72, 4 * E * 3, 4)[mode]
    f32 = E * (STATIC_EDGE_F32 + (3 if mode == 2 else 0)) / FP32_FLOPS
    return edges + out, f32 + (E * STATIC_EDGE_F64 / FP64_FLOPS
                               if mode == 0 else 0)


def _lr_shape(pt_sums, wagg, *rest):      # (P, C)
    return (pt_sums.shape[0], wagg.shape[1] // 18)


def _lr_bound(shape, args):
    """pt_sums, Wagg, the valid flags and lam read once, Hpp^-1 and Aagg
    written once; an inverse a point and an Aagg row a (point, camera,
    row)."""
    P, C = shape
    return 48 * P + 72 * P * C + P + 4 + 36 * P + 72 * P * C, \
        (P * POINT_INVERSE_F64 + 6 * P * C * AAGG_ROW_F64) / FP64_FLOPS


def _lb_shape(hinv, pt_sums, wagg, *rest):  # (P, C)
    return (pt_sums.shape[0], wagg.shape[1] // 18)


def _lb_bound(shape, args):
    """Hpp^-1, bp, Wagg, dx_c and the valid flags read once, dx_p written
    once."""
    P, C = shape
    return 36 * P + 12 * P + 72 * P * C + 24 * C + P + 12 * P, \
        (P * C * BACKSUB_CAMERA_F64 + P * BACKSUB_POINT_F64) / FP64_FLOPS


def _hu_shape(camR, camt, joints, seg_len, motR, mott, tb, *rest):
    # (edges of each family, mode)
    return tuple(_bhu().family_sizes(tb)) + (int(rest[-1]),)


def _hu_fmt(shape) -> str:
    Eh, Er, Em, mode = shape
    return (f"{Eh} projection, {Er} rigidity, {Em} motion edges, "
            f"{_ST_MODES[mode]} mode")


def _hu_bound(shape, args):
    """The state (cameras, joints, limbs, motions) and the edge tables
    read once (the activities in Gauss-Newton and cost-sum modes), the
    column (90, 56, 156 floats an edge), the costs or the three sums
    written once; the cost sums' guard, product and add a term at the
    float32 rate."""
    Eh, Er, Em, mode = shape
    camR, joints, seg_len, motR = args[0], args[2], args[3], args[4]
    state = 48 * camR.shape[0] + 4 * joints.numel() + 4 * seg_len.numel() \
        + 48 * motR.shape[0]
    tables = 20 * Eh + 12 * Er + 16 * Em
    E = (Eh, Er, Em)
    f32 = sum(e * f for e, f in zip(E, HUMAN_F32)) / FP32_FLOPS
    if mode == 1:
        return state + tables + 4 * (2 * sum(E) + Eh), f32
    if mode == 2:
        return state + tables + 4 * sum(E) + 12, \
            f32 + 3 * sum(E) / FP32_FLOPS
    out = 4 * (90 * Eh + 56 * Er + 156 * Em)
    return state + tables + 4 * sum(E) + out, \
        f32 + sum(e * f for e, f in zip(E, HUMAN_F64)) / FP64_FLOPS


def _hu_check(args):
    """_ba_check's, and in cost-sum mode also bit-equal to lm_cost_ref of
    each family's cost-mode rho on the card (the order the sums keep)."""
    import torch
    from airdos_tpu_torch.ops.lm_cost import lm_cost_ref
    bh = _bhu()
    err, what, kernel, plain = _ba_check(
        "human_edge_blocks", lambda: bh.human_edges_cuda,
        lambda: bh.human_edges_ref)(args)
    if int(args[-1]) == bh.COST_SUM:
        got = bh.human_edges_cuda(*args)
        rho = bh.human_edges_cuda(*args[:-1], bh.COST).rho
        sums = [lm_cost_ref(r, a) for r, a in
                zip(rho.split(list(bh.family_sizes(args[6]))), args[7])]
        torch.cuda.synchronize()
        if not _bits_equal(got, torch.stack(sums)):
            _fail(f"human_edge_blocks cost sum {got.tolist()} != "
                  f"lm_cost_ref of the cost mode's rho "
                  f"{[float(x) for x in sums]}")
        what += ", equal to lm_cost_ref of the cost mode's rho"
    return err, what, kernel, plain


# ------------------------------------------------------ matcher kernels

_MATCH_MODES = ("motion", "local", "stereo", "bow", "fuse", "epipolar")
# operations counted from csrc/match.cu.  The function's need (the
# bound): a row's work (its loads, window or bucket, the two warp
# minima, the ratio test and its outputs), a column's (its cell or bucket:
# binned once, however many blocks stage it), and at each gated pair the
# gate (by mode: motion and local the flags, the octave band's two
# bounds, the two window subtractions, absolute values and compares, the
# right-u test; stereo the band, octave and disparity tests; bow key
# equality; fuse the window, the octave band and the chi-square's float32
# steps; epipolar the line's distance and its compare) and the pair (8
# XORs, 8 popcounts, 7 adds, the key and the two-smallest update),
# stereo's extra work a gated pair (the far-u
# test's subtraction, absolute value and compare, and the column
# minimum's compare), and the resolve's work a row (the rotation bin and
# histogram add, the key and its atomicMin, the winner test).  The full
# scan's bound, the gate at every pair, is printed beside it.
MATCH_GATE_OPS = (14, 14, 10, 4, 24, 10)
MATCH_PAIR_OPS = 27
MATCH_STEREO_PAIR_OPS = 4
MATCH_ROW_OPS = 24
MATCH_COL_OPS = 8
RESOLVE_ROW_OPS = (12, 24)        # without, with the rotation filter
# bytes a row and a column of match_rows read (the descriptor's 32, the
# vectors and flags of the mode; fuse: a row's vectors a target, its
# descriptor once; epipolar: a row's line a target, its descriptor, key
# and ok once) and a row writes (best and second 16, their distances 8,
# has 1; fuse, epipolar: best and feat_idx 16, its distance 4, has 1)
MATCH_ROW_BYTES = (57, 57, 49, 41, 25, 12)
MATCH_COL_BYTES = (54, 54, 53, 41, 54, 53)
MATCH_OUT_BYTES = (25, 25, 25, 25, 21, 21)
MATCH_SHARED_ROW_BYTES = (0, 0, 0, 0, 32, 41)


def _mr_shape(mode, rows, cols, th, ratio=0.0, band=(None, None),
              max_d=0.0, resolve=False, angles=None, *rest):
    """(mode, rows, columns, targets, resolve, rotation filter)"""
    batched = int(mode) in _match().BATCHED
    return (int(mode), rows.desc.shape[0], cols.desc.shape[-2],
            cols.desc.shape[0] if batched else 1, bool(resolve),
            angles is not None)


def _rs_shape(*args):
    """match_resolve's shape: match_rows' where it ran the resolve, else
    None (not recorded)."""
    shape = _mr_shape(*args)
    return shape if shape[4] else None


def _mr_fmt(shape) -> str:
    mode, P, N, B, resolve, rot = shape
    what = f"{_MATCH_MODES[mode]} mode, {P} rows x {N} columns"
    if mode in _match().BATCHED:
        what += f" x {B} targets"
    if resolve:
        what += f", the resolve with the rotation filter {'on' if rot else 'off'}"
    return what


def _mr_args(args, check=True):
    """The recorded arguments with the inputs checked (the matchers pass
    check=False)."""
    return tuple(args[:10]) + (check,)


def _mr_gated(args) -> int:
    """The pairs inside the gate on these inputs (the plain version's
    gate)."""
    mode, rows, cols, th, ratio, band, max_d, resolve, angles, sigma2 = \
        args[:10]
    return int(_match().gate(mode, rows, cols, band, max_d, sigma2).sum())


def _mr_bytes(shape) -> int:
    mode, P, N, B, resolve, rot = shape
    stereo = mode == _match().STEREO
    nbytes = B * P * (MATCH_ROW_BYTES[mode] + MATCH_OUT_BYTES[mode]) \
        + B * N * (MATCH_COL_BYTES[mode] + (8 if stereo else 0)) \
        + P * MATCH_SHARED_ROW_BYTES[mode]
    if resolve:           # the angles read, feat_idx, point_of_feat, n
        nbytes += (4 * (P + N) if rot else 0) + 8 * (P + N + 1)
    return nbytes


def _mr_ops(shape, args, old=False) -> int:
    """The function's operations (old: the full scan's count, the gate at
    every pair and no row, column or resolve work)."""
    mode, P, N, B, resolve, rot = shape
    stereo = mode == _match().STEREO
    gated = _mr_gated(args)
    pair = MATCH_PAIR_OPS + (MATCH_STEREO_PAIR_OPS if stereo else 0)
    if old:
        return B * P * N * MATCH_GATE_OPS[mode] + gated * pair
    return B * P * MATCH_ROW_OPS + B * N * MATCH_COL_OPS \
        + gated * (MATCH_GATE_OPS[mode] + pair)


def _mr_bound(shape, args):
    """Both descriptor sets and the row and column vectors read once, the
    outputs written once (stereo: each column's argmin too); a row's and
    a column's work and the gate and popcount at the gated pairs only,
    once in every mode (stereo adds the far-u test and the column minimum
    at the gated pairs), at the float32 CUDA-core rate (the table lists no
    int32 rate).  The call's resolve is match_resolve's row."""
    return _mr_bytes(shape[:4] + (False, False)), \
        _mr_ops(shape[:4] + (False, False), args) / FP32_FLOPS


def _rs_bound(shape, args):
    """The whole launch with the resolve: match_rows' bound plus best,
    dist and has read once more (with the rotation filter the row angles
    and the angle table too), feat_idx, point_of_feat and n written once,
    and the resolve's work a row."""
    mode, P, N, B, resolve, rot = shape
    return _mr_bytes(shape) + 13 * P, \
        (_mr_ops(shape, args) + P * RESOLVE_ROW_OPS[rot]) / FP32_FLOPS


_MR_EDGES = {}                    # the edge cases, once a run


def _mr_edges():
    """tests/torch_match_cases.py's cases (every mode; the path's and the
    grid's edge cases: windows over the image border, columns on the
    cells' boundaries, non-finite rows and columns, every column in one
    cell, empty windows, rows with no gated pair) at 48 x 96 (fuse: 3
    targets) and 300 x 500: every output bit-equal to the plain version
    on the card, two launches equal, once a run -> the count."""
    if "n" in _MR_EDGES:
        return _MR_EDGES["n"]
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_match_cases as tc
    mk = _match()
    n = 0
    for m in range(len(tc.MODES)):
        for case in tc.CASES:
            for P, N in ((48, 96), (300, 500)):
                rng = np.random.default_rng(
                    1000 * m + 10 * tc.CASES.index(case) + P)
                args = tc.args(tc.make(m, case, rng, P, N, 3), "cuda")
                got, again = mk.match_rows_cuda(*args), \
                    mk.match_rows_cuda(*args)
                want = mk.match_rows_ref(*args)
                torch.cuda.synchronize()
                for name in mk.RowMatches._fields:
                    if not torch.equal(getattr(got, name),
                                       getattr(want, name)):
                        _fail(f"match_rows {name} != plain version on the "
                              f"{tc.MODES[m]} {case!r} case, {P} x {N}")
                    if not torch.equal(getattr(got, name),
                                       getattr(again, name)):
                        _fail(f"match_rows: two launches differ in {name} "
                              f"on the {tc.MODES[m]} {case!r} case")
                n += 1
    _MR_EDGES["n"] = n
    return n


def _mr_check(args):
    """Every output bit-equal to the plain version (pure torch) on the
    card, two launches equal, the grid's edge cases once (_mr_edges), and
    the eager composition the kernel replaced (the plain version's gate
    and reductions around the 2-D Hamming kernel, or the batched one in
    fuse and epipolar mode, and the resolve's plain version) timed."""
    import torch
    mk, hk = _match(), _hamming()
    args = _mr_args(args)
    got, again = mk.match_rows_cuda(*args), mk.match_rows_cuda(*args)
    want = mk.match_rows_ref(*args[:10])
    torch.cuda.synchronize()
    shape = _mr_shape(*args)
    for name in mk.RowMatches._fields:
        g, w = getattr(got, name), getattr(want, name)
        if not torch.equal(g, w):
            err = int((g.long() - w.long()).abs().max()) \
                if g.numel() and g.shape == w.shape else -1
            _fail(f"match_rows {name} != plain version ({_mr_fmt(shape)}, "
                  f"max abs err {err})")
        if not torch.equal(g, getattr(again, name)):
            _fail(f"match_rows: two launches differ in {name}")
    mode, rows, cols, th, ratio, band, max_d, resolve, angles, sigma2 = \
        args[:10]

    def composition():
        ok = mk.gate(mode, rows, cols, band, max_d, sigma2)
        D = hk.hamming_matrix_batched(rows.desc[None], cols.desc) \
            if mode in mk.BATCHED else hk.hamming_matrix(rows.desc, cols.desc)
        D = torch.where(ok, D, torch.full_like(D, mk.BIG))
        rm = mk.reduce_gated(mode, D, cols.key, cols.x, th, ratio)
        if resolve:
            mk.match_resolve_ref(rm.best, rm.dist, rm.has, cols.desc.shape[0],
                                 *(angles or (None, None)))
        return rm

    comp_ms = _cuda_ms(composition)
    n_edges = _mr_edges()
    old_bound = _mr_ops(shape, args, old=True) / FP32_FLOPS * 1e3
    what = (f"bit-equal ({', '.join(mk.RowMatches._fields)}), two launches "
            f"equal, {int(got.has.sum())} of {got.has.numel()} rows matched, "
            f"{_mr_gated(args)} gated pairs; {n_edges} edge cases "
            f"(tests/torch_match_cases.py) bit-equal; the eager composition "
            f"it replaced (the gate and reductions around the "
            f"{'batched ' if mode in mk.BATCHED else '2-D '}Hamming kernel"
            f"{', and the resolve' if resolve else ''}) {comp_ms:.4f} ms per "
            f"call; the full scan's bound (the gate at every pair) "
            f"{max(old_bound, _mr_bytes(shape) / HBM_BYTES_PER_S * 1e3) * 1e3:.3f} us")
    return 0, what, (lambda: mk.match_rows_cuda(*args)), \
        (lambda: mk.match_rows_ref(*args[:10]))


def _rs_fmt(shape) -> str:
    return _mr_fmt(shape) + " (the resolve folded into match_rows' launch)"


def _rs_check(args):
    """match_rows with the resolve, held as _mr_check holds it; beside
    it the device time of the same call without the resolve, whose
    difference is what the folded resolve costs (a launch of its own
    before it was folded in)."""
    mk = _match()
    err, what, kernel, plain = _mr_check(args)
    bare = _mr_args(args)
    bare = bare[:7] + (False, None) + bare[9:]
    with_cold, _ = _graph_ms(kernel)
    bare_cold, _ = _graph_ms(lambda: mk.match_rows_cuda(*bare))
    what += (f"; device time cold with the resolve {with_cold:.4f} ms, "
             f"without {bare_cold:.4f} ms: the folded resolve "
             f"{with_cold - bare_cold:.4f} ms")
    return err, what, kernel, plain


# ------------------------------------------------------- triangulation

# operations a row of triangulate (counted from csrc/triangulate.cu): the
# rays and their parallax (~50), the DLT rows, normal equations, damping,
# inverse and solve (~165), the stereo point (~12), the two views' checks
# (~80) and the scale test (~26), and atan2f, cosf (twice each) and expf
# counted at ~20 operations each
TRI_ROW_OPS = 450
# bytes a row of a target reads (best 8, dist 4, the neighbour's matched
# feature: xy 8, octave 8, ur 4, depth 4) and writes (idx2 8, the point
# 12, three flags 3), and a keyframe row reads once (xy, octave, ur, depth)
TRI_ROW_BYTES = 36 + 23
TRI_KF_ROW_BYTES = 24


def _tri_shape(best, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, *rest):
    """(targets, keyframe rows, a neighbour's features)"""
    return (best.shape[0], best.shape[1], xy2.shape[1])


def _tri_fmt(shape) -> str:
    return f"B={shape[0]} x {shape[1]} rows ({shape[2]} features a neighbour)"


def _tri_bound(shape, args):
    """Each row's inputs read once (its match's feature gathered once),
    its outputs written once, TRI_ROW_OPS a row at the float32 CUDA-core
    rate."""
    B, N1, N2 = shape
    nbytes = B * N1 * TRI_ROW_BYTES + N1 * TRI_KF_ROW_BYTES + 4 * (24 * B + 15)
    return nbytes, B * N1 * TRI_ROW_OPS / FP32_FLOPS


def _tri_check(args):
    """Every output bit-equal to triangulate_rows_ref on the card, two
    launches equal; beside it the per-call time of the eager triangulation
    it replaced (tests/torch_triangulate_cases.py's composition after its
    argmin) on the same rows, and of the whole triangulate_pair against
    the whole composition (the [B, N1, N2] gate around the batched Hamming
    kernel) on the path's inputs at this shape."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_triangulate_cases as ttc
    tk = _tri()
    got = tk.triangulate_rows_cuda(*args)
    again = tk.triangulate_rows_cuda(*args)
    want = tk.triangulate_rows_ref(*args)
    torch.cuda.synchronize()
    err = float((got.points - want.points).abs().nan_to_num(0.0).max()) \
        if got.points.numel() else 0.0
    for name in tk.TriangulationResult._fields:
        g, w = getattr(got, name), getattr(want, name)
        if not torch.equal(g, w):
            rows = int((g != w).reshape(g.shape[0], g.shape[1], -1).any(-1)
                       .sum())
            _fail(f"triangulate {name} != plain version on {rows} of "
                  f"{g.shape[0] * g.shape[1]} rows (points' max abs err "
                  f"{err})")
        if not torch.equal(g, getattr(again, name)):
            _fail(f"triangulate: two launches differ in {name}")
    (best, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, oct2, ur2, depth2, R2,
     t2, C1w, C2w, fx, fy, cx, cy, bf, sf, s2, ls) = args
    rows_ms = _cuda_ms(lambda: ttc._composition_rows(
        best, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, oct2, ur2, depth2,
        R2, t2, fx, fy, cx, cy, bf, sf, s2, ls))
    what = (f"bit-equal ({', '.join(tk.TriangulationResult._fields)}), two "
            f"launches equal, {int(got.valid.sum())} of {got.valid.numel()} "
            f"rows valid; the eager triangulation it replaced "
            f"{rows_ms:.4f} ms per call")
    pair = _FOR_TRI.get(_tri_shape(*args))
    if pair is not None:
        from airdos_tpu_torch.matching.epipolar import triangulate_pair
        new_ms = _cuda_ms(lambda: triangulate_pair(*pair))
        old_ms = _cuda_ms(lambda: ttc.composition(*pair))
        what += (f"; triangulate_pair {new_ms:.4f} ms per call against the "
                 f"composition it replaced {old_ms:.4f} ms")
    return err, what, (lambda: tk.triangulate_rows_cuda(*args)), \
        (lambda: tk.triangulate_rows_ref(*args))


# --------------------------------------------- the loop correction's solvers

# float32 operations a unit of work, counted from csrc/ba_global.cu: a
# point-walk row (the masked camera step 6, Wcp^T x
# 18 products and 15 sums, the point's sum 3) and a point's Hpp^-1 (15); a
# camera-walk row (Wcp z: 18 products, 12 sums, the camera's sum 6) and a
# camera's Ap, its share of the dot products and its CG update (Hcc_d xm
# 66, Ap 24, p.Ap 11, x 12, r 12, D^-1 r 66, r.z 11, p 12, the two fixed
# sums 2)
SCHUR_POINT_ROW, SCHUR_POINT_HINV = 42, 15
SCHUR_CAMERA_ROW, SCHUR_CAMERA_CAM = 36, 222
# sim3_edges' float32 operations an edge, counted from csrc/sim3_edges.cu
# as (value, shared, tangent): an add, multiply, divide, square root or
# transcendental is one operation (its least), a negation, clamp or
# comparison none.  A dual number's value costs what its float does; its
# tangent in one direction a sum 1 (0 beside a constant), a product 3 (1
# by a constant), a quotient 3 (1 by a constant), sqrt, sin, cos, exp and
# log 1, atan2 3; each derivative's factor that no direction changes (a
# reciprocal, 1 / 2 sqrt, a sine for a cosine not also taken, atan2's x /
# n and y / n) is shared, once an edge.  The residual but so3_log and V:
# sim3_inverse (1 + 15 + 3 values), compose twice (45 + 15 + 6 + 1 each),
# the scale's log (1) and V v = t by the adjugate (27 + 6 + 18 values, 36
# tangent operations): 205 values, 291 tangent operations.  so3_log's
# generic, small-angle and near-pi branches; V in its regimes by (sigma
# small, theta small), W^2 as w w^T - |w|^2 I and V's 9 distinct products.
# A Gauss-Newton edge: its values once, the shared factors once, 14
# tangents, w J (98), J^T w J's 105 distinct entries (7 products, 6 sums)
# and J^T w e's 14; a cost edge: its values, |e|^2 (13), times w, its sum.
SIM3_CORE = (205, 2, 291)
SIM3_LOG = {"generic": (21, 9, 36), "small": (22, 8, 36),
            "near_pi": (38, 18, 68)}
SIM3_V = {(True, True): (38, 2, 68), (True, False): (43, 4, 78),
          (False, True): (42, 4, 70), (False, False): (56, 6, 112)}
SIM3_SYSTEM = 98 + 105 * 13 + 14 * 13
SIM3_COST = 15


def _on_cpu(x):
    """A recorded argument copied to the CPU (tensors, and named tuples of
    tensors and ints such as a Walk or a CGState)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on_cpu(y) for y in x))
    return x


def _sp_view(launch, raw=False):
    """A PointLaunch call (the solver's, prepared once a step) as
    schur_point_ref's arguments."""
    return (launch.w_p, launch.walk_p, launch.x, launch.cam_free,
            launch.hpp_inv, raw)


def _sc_view(launch, z, raw=False):
    """A CameraLaunch call as schur_camera_ref's arguments."""
    return (launch.w_c, launch.walk_c, z, launch.state, launch.hcc_d,
            launch.d_inv, launch.cam_free, raw)


def _sp_shape(w_p, walk, x, cam_free, hpp_inv, raw):  # (E, P, C, raw)
    return (w_p.shape[0], walk.n, x.shape[0], int(raw))


def _sc_shape(w_c, walk, z, *rest):                   # (E, P, C, raw)
    return (w_c.shape[0], z.shape[0], walk.n, int(rest[-1]))


def _schur_fmt(shape) -> str:
    E, P, C, raw = shape
    return (f"E={E} P={P} C={C}" + (" raw (a mesh rank's sums)" if raw
                                    else ""))


def _walked(walk) -> str:
    return (f"{int(walk.offsets[-1])} rows walked, longest segment "
            f"{int(walk.offsets.diff().max())}")


def _sp_once(w_p, walk, x, cam_free, hpp_inv, raw):
    """One launch of schur_point through a PointLaunch made for it (on the
    stream current now: a graph's capture stream too)."""
    return _bgl().PointLaunch(w_p, walk, x, cam_free, hpp_inv)(raw)


def _sc_once(w_c, walk, z, state, hcc_d, d_inv, cam_free, raw):
    """One launch of schur_camera through a CameraLaunch made for it."""
    return _bgl().CameraLaunch(w_c, walk, state, hcc_d, d_inv, cam_free,
                               z.shape[0])(z, raw)


def _sp_check(args):
    """Bit-equal to schur_point_ref on a CPU copy (its segment sums are
    index_add_ in walk order, atomics on the card), two launches bit-equal;
    beside it the per-call time of the eager composition it replaced: the
    gather, products, point-keyed segment_sum and Hpp^-1 einsum."""
    import torch
    bg, sk = _bgl(), _segments()
    got = _sp_once(*args)
    again = _sp_once(*args)
    want = bg.schur_point_ref(*(_on_cpu(a) for a in args))
    torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max()) if got.numel() else 0.0
    if not _bits_equal(got.cpu(), want):
        _fail(f"schur_point != plain version (max abs err {err})")
    if not _bits_equal(got, again):
        _fail("schur_point: two launches differ")
    w_p, walk, x, cam_free, hpp_inv, raw = args
    E = w_p.shape[0]
    wcp = w_p.reshape(E, 6, 3)
    key = walk.key
    seg = sk.Segments(key=key, perm=torch.arange(E, dtype=torch.int32,
                                                 device=key.device),
                      offsets=walk.offsets, n=walk.n)
    cam = walk.other.long()

    def old():
        xm = x * cam_free[:, None]
        y = torch.einsum("ekl,ek->el", wcp, xm[cam])
        sums = sk.segment_sum(y, seg)
        return sums if raw else torch.einsum("plm,pm->pl", hpp_inv, sums)

    old_ms = _cuda_ms(old)
    launch = bg.PointLaunch(*args[:5])
    prepared_ms = _cuda_ms(lambda: launch(raw))
    what = (f"bit-equal to the plain version on a CPU copy, two launches "
            f"bit-equal; {_walked(walk)}; prepared once (the solver's "
            f"PointLaunch) {prepared_ms:.4f} ms per call; the eager "
            f"composition it replaced {old_ms:.4f} ms per call")
    return err, what, (lambda: _sp_once(*args)), \
        (lambda: bg.schur_point_ref(*args))


def _sc_check(args):
    """The CG update (or, raw, the sums) bit-equal to schur_camera_ref on a
    CPU copy, two launches bit-equal, each launch on its own copy of the
    recorded CG state."""
    import torch
    bg = _bgl()
    w_c, walk, z, state, hcc_d, d_inv, cam_free, raw = args

    def call(fn, st, where=lambda a: a):
        return fn(*(where(a) for a in (w_c, walk, z)), st,
                  *(where(a) for a in (hcc_d, d_inv, cam_free)), raw)

    s1, s2, s3 = _cloned(state), _cloned(state), _on_cpu(state)
    o1 = call(_sc_once, s1)
    o2 = call(_sc_once, s2)
    o3 = call(bg.schur_camera_ref, s3, _on_cpu)
    torch.cuda.synchronize()
    got, again, want = ((o,) if raw else tuple(o[:4]) for o in (o1, o2, o3))
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want))
    if not all(_bits_equal(a.cpu(), b) for a, b in zip(got, want)):
        _fail(f"schur_camera != plain version (max abs err {err})")
    if not all(_bits_equal(a, b) for a, b in zip(got, again)):
        _fail("schur_camera: two launches differ")
    sk_, sp_ = _cloned(state), _cloned(state)
    launch = bg.CameraLaunch(w_c, walk, _cloned(state), hcc_d, d_inv,
                             cam_free, z.shape[0])
    prepared_ms = _cuda_ms(lambda: launch(z, raw))
    what = (f"bit-equal to the plain version on a CPU copy "
            f"({'back' if raw else 'x, r, p, rz'}), two launches bit-equal; "
            f"{_walked(walk)}; {launch.grid} blocks (cooperative); "
            f"prepared once (the "
            f"solver's CameraLaunch) {prepared_ms:.4f} ms per call")
    return err, what, (lambda: call(_sc_once, sk_)), \
        (lambda: call(bg.schur_camera_ref, sp_))


def _sp_bound(shape, args):
    """The walked rows (72 B of Wcp, 4 of the camera) read once, the
    offsets, x, cam_free and Hpp^-1 read once, z written once."""
    E, P, C, raw = shape
    kept = int(args[1].offsets[-1])
    nbytes = 76 * kept + 4 * (P + 1) + 28 * C + (0 if raw else 36 * P) + \
        12 * P
    ops = kept * SCHUR_POINT_ROW + (0 if raw else P * SCHUR_POINT_HINV)
    return nbytes, ops / FP32_FLOPS


def _sc_bound(shape, args):
    """The walked rows (72 B of Wcp, 4 of the point) read once, the
    offsets and z read once; raw: back written once; else the update's
    inputs Hcc_d, D^-1, cam_free, x, r, p and rz read once and x, r, p, rz
    written once.  The scratch (ap, and the cameras' partial dot products
    that every block of the update sums from L2) is not the function's
    and is not counted."""
    E, P, C, raw = shape
    kept = int(args[1].offsets[-1])
    nbytes = 76 * kept + 4 * (C + 1) + 12 * P + \
        (24 * C if raw else 292 * C + 144 * C + 8)
    ops = kept * SCHUR_CAMERA_ROW + (0 if raw else C * SCHUR_CAMERA_CAM)
    return nbytes, ops / FP32_FLOPS


def _s3_shape(R, t, s, e_i, *rest):          # (K, E, cost)
    return (t.shape[0], e_i.shape[0], int(rest[-1]))


def _s3_fmt(shape) -> str:
    K, E, cost = shape
    return f"K={K} E={E} {'cost' if cost else 'Gauss-Newton'} mode"


def _s3_check(args):
    """The cost within SYSTEM_RTOL of the plain version's (the residuals'
    torch.sum) on the card; the system held to the plain version in
    float64 (its reverse-mode Jacobians and scatter_values) edge by edge:
    J^T J within SYSTEM_RTOL of its largest entry, J^T e within SYSTEM_RTOL
    of |J| |e| plus F32_FLOOR of |J| times its translation scale, or no
    farther than twice the plain version in float32 is
    (pose_graph_kernels.held, edge_gaps); two launches bit-equal."""
    import torch
    pk = _pgk()
    got = pk.sim3_edges_cuda(*args)
    again = pk.sim3_edges_cuda(*args)
    want = pk.sim3_edges_ref(*args)
    torch.cuda.synchronize()
    if not _bits_equal(got, again):
        _fail("sim3_edges: two launches differ")
    if not bool(torch.isfinite(got).all()):
        _fail("sim3_edges: non-finite outputs")
    err = float((got - want).abs().max())
    if args[-1]:
        gap = err / max(float(want.abs()), 1e-30)
        if not gap <= pk.SYSTEM_RTOL:
            _fail(f"sim3_edges cost: {gap} of itself from the plain version "
                  f"(> {pk.SYSTEM_RTOL})")
        what = f"cost within {gap:.2e} of the plain version's"
    else:
        ok, mine, plain = pk.held(got, *args[:9])
        direct = pk.system_gap(got, want, *args[:9])
        gaps = (f"J^T J {mine[0]:.3g}, J^T e {mine[1]:.3g} of an edge's "
                f"tolerance from the plain version in float64, the plain "
                f"version in float32 {plain[0]:.3g}, {plain[1]:.3g}; from "
                f"it {direct[0]:.3g}, {direct[1]:.3g}")
        if not ok:
            _fail(f"sim3_edges: {gaps} (> 1 and twice the plain "
                  f"version's)")
        what = gaps
    what += ", two launches bit-equal"
    return err, what, (lambda: pk.sim3_edges_cuda(*args)), \
        (lambda: pk.sim3_edges_ref(*args))


def _s3_ops(args, cost) -> int:
    """sim3_edges' operations on these inputs: each edge at the branches
    its residual takes (theta = |e[3:6]| and sigma = e[6] of the plain
    version's residuals, float32 on the card)."""
    import torch
    pk = _pgk()
    e = pk.residuals(*args[:8])
    theta = torch.linalg.norm(e[:, 3:6], dim=1)
    log_pi = torch.cos(theta) < -0.999
    log_small = ~log_pi & (torch.sin(theta).abs() < 1e-6)
    small_s = (e[:, 6].abs() < 1e-6).tolist()
    small_t = (theta * theta < 1e-8).tolist()
    logs = ["near_pi" if p else "small" if q else "generic"
            for p, q in zip(log_pi.tolist(), log_small.tolist())]
    ops = 0
    for lg, ss, st in zip(logs, small_s, small_t):
        v, sh, d = (a + b + c for a, b, c in zip(
            SIM3_CORE, SIM3_LOG[lg], SIM3_V[(ss, st)]))
        ops += v + SIM3_COST if cost else v + sh + 14 * d + SIM3_SYSTEM
    return ops


def _s3_bound(shape, args):
    """The vertices (52 B) and each edge's indices, measurement and weight
    (64 B) read once, the system (840 B an edge) or the cost written once;
    the operations _s3_ops counts."""
    K, E, cost = shape
    nbytes = 52 * K + 64 * E + (4 if cost else 840 * E)
    return nbytes, _s3_ops(args, cost) / FP32_FLOPS


# --------------------------- relocalization's and the loop's geometry

# Operations counted from csrc/ransac.cu and csrc/small_eig.cuh.  A Jacobi
# sweep of an N x N matrix: N (N - 1) / 2 rotations of 18 N + 20 float64
# operations; every decomposition is counted at one sweep (they stop when
# the off-diagonal is zero, after several: the bound is a lower bound).
# EPnP's dense work but its sweeps (M^T M 80, the canonical basis 912, G
# and rho 606, two candidates of 6 Gauss-Newton steps with their 4 x 4
# solves, x, c1, M, Horn's N, quaternion and t: 2 x 4,180 less their
# sweep, the control points and A^-1 170), and its float64 operations a
# point of the set (centroid 7, covariance 22, alphas and the 56 sums
# 182, the two candidates' errors 60); Horn's dense work but its sweep
# (N, quaternion, s, t) and a point's sums (13 + 39); the inlier tests'
# float32 operations a point and hypothesis (EPnP 30, Horn's mutual test
# 80).
def _jacobi_sweep(N: int) -> int:
    return N * (N - 1) // 2 * (18 * N + 20)


EPNP_DENSE = 80 + 912 + 606 + 2 * (4180 - _jacobi_sweep(4)) + 170 + \
    _jacobi_sweep(12) + 3 * _jacobi_sweep(4) + _jacobi_sweep(3)
EPNP_POINT = 7 + 22 + 182 + 60
EPNP_TEST = 30
HORN_DENSE = 100 + _jacobi_sweep(4)
HORN_POINT = 13 + 39
HORN_TEST = 80
# csrc/sim3_opt.cu: a pair's Gauss-Newton pass (residuals and Jacobians
# 400, H and g 280) and cost pass (70), a step's solve and two poses (730)
SIM3_OPT_PAIR_STEP = 680 + 70
SIM3_OPT_PAIR_COST = 70
SIM3_OPT_STEP = 730
# csrc/voc_transform.cu: a child's XOR, popcount and sum of 8 words and
# its compare
VOC_CHILD_OPS = 26


def _eh_shape(pw, uv, valid, max_err2, sample_idx, *rest):   # (H, n)
    return (sample_idx.shape[0], pw.shape[0])


def _er_shape(pw, *rest):                                     # (n,)
    return (pw.shape[0],)


def _hh_shape(x1, x2, valid, g1, g2, sample_idx, *rest):      # (H, n, fix)
    return (sample_idx.shape[0], x1.shape[0], bool(rest[-1]))


def _hr_shape(x1, *rest):                                     # (n, fix)
    return (x1.shape[0], bool(rest[-1]))


def _hyp_fmt(shape) -> str:
    return f"H={shape[0]} n={shape[1]}" + \
        (f" fix_scale={shape[2]}" if len(shape) > 2 else "")


def _refine_fmt(shape) -> str:
    return f"n={shape[0]}" + (f" fix_scale={shape[1]}" if len(shape) > 1
                              else "")


def _as64(args, idx):
    """args with the float32 tensors at positions idx in float64."""
    return tuple(a.double() if i in idx else a for i, a in enumerate(args))


def _launches_equal(got, again) -> bool:
    import torch
    return all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
               if a.is_floating_point() else torch.equal(a, b)
               for a, b in zip(got, again))


def _hyp_stats(st, other: str) -> str:
    return (f"{st['hypotheses']} hypotheses, {st['degenerate']} degenerate "
            f"(NaN and no inliers in both), counts equal to the plain "
            f"version's on {st['count_share']:.4f} (to it solved in "
            f"{other}: {st['count_share_other']:.4f}), poses within "
            f"{st['pose_gap']:.2e} of it on the {st['well_posed']} well-posed "
            f"samples (median {st['pose_gap_median']:.1e} over all)")


def _eh_check(args):
    """EPnP hypotheses against the plain version with the kernel's rule
    for the eigensolver's choices (canonical=True), the well-posed
    samples told by it solved in float32
    (ops/ransac_kernels.hypotheses_held); two launches bit-equal."""
    import torch
    from airdos_tpu_torch.solvers import epnp as ep
    rk = _rsk()
    got = rk.epnp_hypotheses_cuda(*args)
    again = rk.epnp_hypotheses_cuda(*args)
    plain = ep.epnp_hypotheses_ref(*args, canonical=True)
    other = ep.epnp_hypotheses_ref(*args, canonical=True,
                                   solve_dtype=torch.float32)
    torch.cuda.synchronize()
    if not _launches_equal(got, again):
        _fail("epnp_hypotheses: two launches differ")
    held, st = rk.hypotheses_held(got, plain, other, args[4])
    if not held:
        _fail(f"epnp_hypotheses: not held to its plain version: {st}")
    return st["pose_gap"], _hyp_stats(st, "float32") + \
        ", two launches bit-equal", \
        (lambda: rk.epnp_hypotheses_cuda(*args)), \
        (lambda: ep.epnp_hypotheses_ref(*args, canonical=True))


def _refine_stats(st) -> str:
    return (f"R within {st['R_gap']:.2e}, t {st['t_gap']:.2e} m, s "
            f"{st['s_gap']:.2e} of the plain version (which is "
            f"{st['plain_float32_gap']:.2e} from itself in float64), inlier "
            f"flags equal on {st['inlier_share']:.4f}, inliers "
            f"{st['n_inliers']}, two launches bit-equal")


def _er_check(args):
    """The EPnP refine against the plain version (canonical=True) within
    ops/ransac_kernels.refine_held's tolerances; two launches bit-equal."""
    import torch
    from airdos_tpu_torch.solvers import epnp as ep
    rk = _rsk()
    got = rk.epnp_refine_cuda(*args)
    again = rk.epnp_refine_cuda(*args)
    plain = ep.epnp_refine_ref(*args, canonical=True)
    plain64 = ep.epnp_refine_ref(*_as64(args, (0, 1, 3, 4, 5)),
                                 canonical=True)
    torch.cuda.synchronize()
    if not _launches_equal(got, again):
        _fail("epnp_refine: two launches differ")
    held, st = rk.refine_held(got, plain, plain64)
    if not held:
        _fail(f"epnp_refine: not held to its plain version: {st}")
    return max(st["R_gap"], st["t_gap"]), _refine_stats(st), \
        (lambda: rk.epnp_refine_cuda(*args)), \
        (lambda: ep.epnp_refine_ref(*args, canonical=True))


def _hh_check(args):
    """Horn hypotheses against the plain version, the well-posed samples
    told by it solved in float64 (ops/ransac_kernels.hypotheses_held); two
    launches bit-equal."""
    import torch
    from airdos_tpu_torch.solvers import sim3 as s3
    rk = _rsk()
    got = rk.horn_hypotheses_cuda(*args)
    again = rk.horn_hypotheses_cuda(*args)
    plain = s3.sim3_hypotheses_ref(*args)
    plain64 = s3.sim3_hypotheses_ref(*_as64(args, (0, 1, 3, 4)))
    torch.cuda.synchronize()
    if not _launches_equal(got, again):
        _fail("horn_hypotheses: two launches differ")
    held, st = rk.hypotheses_held(got, plain, plain64, args[5])
    if not held:
        _fail(f"horn_hypotheses: not held to its plain version: {st}")
    return st["pose_gap"], _hyp_stats(st, "float64") + \
        ", two launches bit-equal", \
        (lambda: rk.horn_hypotheses_cuda(*args)), \
        (lambda: s3.sim3_hypotheses_ref(*args))


def _hr_check(args):
    """The Horn refine against the plain version within
    ops/ransac_kernels.refine_held's tolerances; two launches bit-equal."""
    import torch
    from airdos_tpu_torch.solvers import sim3 as s3
    rk = _rsk()
    got = rk.horn_refine_cuda(*args)
    again = rk.horn_refine_cuda(*args)
    plain = s3.sim3_refine_ref(*args)
    plain64 = s3.sim3_refine_ref(*_as64(args, (0, 1, 3, 4, 5, 6, 7)))
    torch.cuda.synchronize()
    if not _launches_equal(got, again):
        _fail("horn_refine: two launches differ")
    held, st = rk.refine_held(got, plain, plain64)
    if not held:
        _fail(f"horn_refine: not held to its plain version: {st}")
    return max(st["R_gap"], st["t_gap"]), _refine_stats(st), \
        (lambda: rk.horn_refine_cuda(*args)), \
        (lambda: s3.sim3_refine_ref(*args))


def _eh_bound(shape, args):
    """pw, uv, valid and the gate read once (25 B a point), the samples
    (16 B) and each hypothesis's pose, flags and count written once; the
    float64 work of EPNP_DENSE a hypothesis and EPNP_POINT a sample point,
    the float32 inlier test of every point by every hypothesis."""
    H, n = shape
    nbytes = 25 * n + 16 * H + H * (48 + n + 8)
    return nbytes, H * (EPNP_DENSE + 4 * EPNP_POINT) / FP64_FLOPS + \
        H * n * EPNP_TEST / FP32_FLOPS


def _er_bound(shape, args):
    (n,) = shape
    nbytes = 26 * n + 48 + 48 + n + 8
    return nbytes, (EPNP_DENSE + n * EPNP_POINT) / FP64_FLOPS + \
        n * EPNP_TEST / FP32_FLOPS


def _hh_bound(shape, args):
    H, n, _ = shape
    nbytes = 33 * n + 12 * H + H * (52 + n + 8)
    return nbytes, H * (HORN_DENSE + 3 * HORN_POINT) / FP64_FLOPS + \
        H * n * HORN_TEST / FP32_FLOPS


def _hr_bound(shape, args):
    n, _ = shape
    nbytes = 34 * n + 52 + 52 + n + 8
    return nbytes, (HORN_DENSE + n * HORN_POINT) / FP64_FLOPS + \
        n * HORN_TEST / FP32_FLOPS


def _so_shape(R0, t0, s0, x1, *rest):          # (n, fix_scale, n_iters)
    return (x1.shape[0], bool(rest[-2]), int(rest[-1]))


def _so_fmt(shape) -> str:
    return f"n={shape[0]} fix_scale={shape[1]} n_iters={shape[2]}"


def _so_check(args):
    """Within ops/sim3_opt_kernels' tolerances of optimize_sim3_ref on the
    card (R 1e-4, t 1e-4 m, s 1e-4 of itself, >= 99% of the inlier
    flags); two launches bit-equal."""
    import torch
    so = _s3o()
    got = so.sim3_opt_cuda(*args)
    again = so.sim3_opt_cuda(*args)
    want = so.optimize_sim3_ref(*args)
    torch.cuda.synchronize()
    if not _launches_equal(got, again):
        _fail("sim3_opt: two launches differ")
    held, st = so.held(got, want)
    if not held:
        _fail(f"sim3_opt: not held to its plain version: {st}")
    return max(st["R_gap"], st["t_gap"]), (
        f"R within {st['R_gap']:.2e}, t {st['t_gap']:.2e} m, s "
        f"{st['s_gap']:.2e} of the plain version, inlier flags equal on "
        f"{st['inlier_share']:.4f}, inliers {st['n_inliers']}, two launches "
        f"bit-equal"), (lambda: so.sim3_opt_cuda(*args)), \
        (lambda: so.optimize_sim3_ref(*args))


def _so_bound(shape, args):
    """The pairs' inputs (49 B a pair) and the start read once, the pose,
    flags and count written once; per step a Gauss-Newton and a cost pass
    over the pairs and the solve, plus each stage's first cost and the two
    re-checks, in float64."""
    n, _, iters = shape
    steps = iters // 2 + iters
    nbytes = 49 * n + 52 + 52 + n + 8
    ops = n * (steps * SIM3_OPT_PAIR_STEP + 4 * SIM3_OPT_PAIR_COST) + \
        steps * SIM3_OPT_STEP
    return nbytes, ops / FP64_FLOPS


def _vt_shape(children, node_desc, word_id, group_of, desc, depth):
    return (desc.shape[0], children.shape[0], children.shape[1], int(depth))


def _vt_fmt(shape) -> str:
    N, nodes, k, depth = shape
    return f"N={N} descriptors, tree of {nodes} nodes (k={k}, depth={depth})"


def _vt_check(args):
    """Bit-equal to voc_transform_ref on the card, two launches equal."""
    import torch
    vk = _voc()
    got = vk.voc_transform_cuda(*args)
    again = vk.voc_transform_cuda(*args)
    want = vk.voc_transform_ref(*args)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("word ids", "groups"), got, again, want):
        if not torch.equal(g, w):
            _fail(f"voc_transform {name} != plain version on "
                  f"{int((g != w).sum())} of {g.numel()} descriptors")
        if not torch.equal(g, a):
            _fail(f"voc_transform: two launches differ in {name}")
    nodes, k = args[0].shape
    return 0, (f"bit-equal (word ids, groups), two launches equal; "
               f"{vk.staged_nodes(nodes, k)} of {nodes} nodes staged"), \
        (lambda: vk.voc_transform_cuda(*args)), \
        (lambda: vk.voc_transform_ref(*args))


def _vt_bound(shape, args):
    """What these descriptors' descents need: each distinct node they
    visit, its k child ids and its existing children's descriptors read
    once, the descriptors read and the ids written once; VOC_CHILD_OPS a
    child a descriptor a level (at the float32 CUDA-core rate)."""
    import torch
    children, node_desc, word_id, group_of, desc, depth = args
    N, _, k, _ = shape
    vk = _voc()
    d64 = desc.to(torch.int64) & 0xFFFFFFFF
    cur = torch.zeros(N, dtype=torch.int64, device=desc.device)
    visited = []
    for _ in range(depth):
        ch = children[cur]
        has = ch >= 0
        visited.append(torch.unique(cur[has.any(-1)]))
        cd = node_desc[torch.clamp(ch, min=0)].to(torch.int64) & 0xFFFFFFFF
        dist = vk._popcount32(cd ^ d64[:, None, :]).sum(-1)
        dist = torch.where(has, dist, torch.full_like(dist, vk.MISSING))
        nxt = torch.gather(ch, 1, torch.argmin(dist, -1)[:, None])[:, 0]
        cur = torch.where(has.any(-1), nxt.to(torch.int64), cur)
    nodes = torch.unique(torch.cat(visited)) if visited else cur[:0]
    n_children = int((children[nodes] >= 0).sum()) if len(nodes) else 0
    leaves = int(torch.unique(cur).numel())
    nbytes = 4 * k * len(nodes) + 32 * n_children + 8 * leaves + 32 * N + 8 * N
    return nbytes, N * depth * k * VOC_CHILD_OPS / FP32_FLOPS


def _vt_variants(shapes):
    """A random full tree of k 10 and depth 6 (1,111,111 nodes, 35.6 MB of
    node descriptors), the shape of ORB-SLAM2's ORBvoc (not in the
    repository), made from SEED, at the paths' largest descriptor batch."""
    import torch
    from airdos_tpu_torch.bow.vocabulary import Vocabulary
    k, depth = 10, 6
    nodes = (k ** (depth + 1) - 1) // (k - 1)
    internal = (k ** depth - 1) // (k - 1)
    rng = np.random.default_rng(SEED)
    children = np.full((nodes, k), -1, np.int32)
    children[:internal] = np.arange(internal)[:, None] * k + 1 + np.arange(k)
    desc = rng.integers(0, 2 ** 32, (nodes, 8), dtype=np.uint64) \
        .astype(np.uint32)
    word_id = np.full(nodes, -1, np.int32)
    word_id[internal:] = np.arange(nodes - internal)
    voc = Vocabulary(k=k, depth=depth, node_desc32=desc, children=children,
                     word_id=word_id,
                     weights=np.ones(nodes - internal, np.float32),
                     n_words=nodes - internal, feature_level=2, device="cuda")
    N = max((sh[0] for sh in shapes), default=2000)
    words = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    d = torch.from_numpy(words.view(np.int32)).cuda()
    return {(N, nodes, k, depth): (*voc._device_tables(), d, depth)}


class _Kernel(NamedTuple):
    """Everything the script knows of one kernel: where it lives, the
    wrapper the main paths' launches are recorded at, how a recorded
    input is keyed, printed and sized, its check against the plain
    version (-> max abs err, what held, the kernel and the plain version
    as callables), its bound (-> bytes it must move, seconds its
    operations take at the peak rate) and its library call."""
    name: str
    module: Callable                # () -> the wrapper's module
    wrapper: str                    # the launching function recorded
                                    # (Class.method: a launcher's)
    launches: str                   # the module's launch count
    source: str
    replaces: str
    shape_of: Callable              # recorded args -> shape key
    fmt: Callable                   # shape -> str
    out_size: Callable              # shape -> output elements (ties)
    check: Callable
    bound: Callable                 # (shape, args) -> (bytes, seconds)
    library: Callable               # args -> (callable or None, its name)
    graph_n: int = 100              # launches in the timed CUDA graph
    human_only: bool = False        # launched by the human layer alone
    loop_only: bool = False         # launched by loop closing alone
    reloc_only: bool = False        # launched by relocalization alone
    off_path: bool = False          # launched by no path (checked alone)
    # recorded {shape: [launches, args]} -> {shape: args}: cases the paths
    # did not launch, checked and timed beside them
    variants: Callable = None
    # the wrapper's call (args, kwargs) -> the arguments recorded, checked
    # and keyed (None: the call's own positional arguments)
    view: Callable = None


# every kernel of the port, in the kernels line's order
KERNELS = (
    _Kernel("hamming_matrix", _hamming, "hamming_matrix_cuda", "launches",
            "airdos_tpu_torch/csrc/hamming.cu",
            "airdos_tpu/ops/pallas_kernels.py:43", _ham_shape, _ham_fmt,
            _ham_out, _ham_check(False), _ham_bound, _ham_library,
            off_path=True, variants=_ham_variants(False)),
    _Kernel("hamming_matrix_batched", _hamming,
            "hamming_matrix_batched_cuda", "batched_launches",
            "airdos_tpu_torch/csrc/hamming.cu",
            "airdos_tpu/ops/pallas_kernels.py:43", _batched_shape,
            _batched_fmt, _ham_out, _ham_check(True), _ham_bound,
            _ham_library, off_path=True, variants=_ham_variants(True)),
    _Kernel("segment_sum", _segments, "segment_sum_cuda", "launches",
            "airdos_tpu_torch/csrc/segment_sum.cu",
            "airdos_tpu/solvers/local_ba.py:119, "
            "airdos_tpu/solvers/human_ba.py:271, "
            "airdos_tpu/solvers/global_ba.py:83, "
            "airdos_tpu/solvers/pose_graph.py:79", _seg_shape, _seg_fmt,
            lambda shape: shape[1] * shape[2], _seg_check, _seg_bound,
            _seg_library),
    _Kernel("pose_lm", _pose, "pose_lm_cuda", "launches",
            "airdos_tpu_torch/csrc/pose_lm.cu",
            "airdos_tpu/solvers/pose_opt.py:88 pose_optimize "
            "(lax.fori_loop :195)", _pose_shape, _pose_fmt,
            lambda shape: shape[0], _pose_check, _pose_bound, _no_library,
            graph_n=20),
    _Kernel("fast_nms", _fast, "fast_nms_levels_cuda", "launches",
            "airdos_tpu_torch/csrc/fast.cu",
            "airdos_tpu/ops/fast.py:32 fast_score_map, "
            "airdos_tpu/ops/fast.py:70 nms_strict", _fast_shape, _fast_fmt,
            lambda shape: sum(h * w for h, w in shape), _fast_check,
            _fast_bound, _no_library),
    _Kernel("orb_desc", _orb, "orb_describe_levels_cuda", "launches",
            "airdos_tpu_torch/csrc/orb_desc.cu",
            "airdos_tpu/ops/orientation.py:115 _angles_onehot, "
            "airdos_tpu/ops/brief.py:88 _samples_onehot", _orb_shape,
            _orb_fmt, lambda shape: sum(shape[1]), _orb_check, _orb_bound,
            _no_library),
    _Kernel("pyramid", _pyr, "build_pyramid_cuda", "launches",
            "airdos_tpu_torch/csrc/pyramid.cu",
            "airdos_tpu/ops/pyramid.py:39 build_pyramid, "
            "airdos_tpu/ops/filters.py:107 resize_bilinear, "
            "airdos_tpu/ops/filters.py:71 erode, "
            "airdos_tpu/ops/filters.py:51 gaussian_blur7", _pyr_shape,
            _pyr_fmt, lambda shape: shape[0] * shape[1],
            _pyr_check, _pyr_bound, _no_library, variants=_pyr_variants),
    _Kernel("select", _sel, "select_keypoints_cuda", "launches",
            "airdos_tpu_torch/csrc/select.cu",
            "airdos_tpu/features/orb.py:74 _select_level_keypoints",
            _sel_shape, _sel_fmt, lambda shape: sum(shape[1]), _sel_check,
            _sel_bound, _no_library),
    _Kernel("stereo_sad", _sad, "stereo_sad_cuda", "launches",
            "airdos_tpu_torch/csrc/stereo_sad.cu",
            "airdos_tpu/matching/stereo.py:53 _sad_windows_onehot, "
            "airdos_tpu/matching/stereo.py:45 _sad_windows_gather",
            _sad_shape, _sad_fmt, lambda shape: shape[0], _sad_check,
            _sad_bound, _no_library),
    _Kernel("patch_disparity", _disp, "patch_disparity_cuda", "launches",
            "airdos_tpu_torch/csrc/disparity.cu",
            "airdos_tpu/ops/disparity.py:27 patch_disparity", _disp_shape,
            _disp_fmt, lambda shape: shape[2], _disp_check, _disp_bound,
            _no_library, human_only=True),
    _Kernel("static_edge_blocks", _bst, "static_edges_cuda", "launches",
            "airdos_tpu_torch/csrc/ba_static.cu",
            "airdos_tpu/solvers/local_ba.py:43 _proj_residual, :107 "
            "gn_step (weights, products) and :176 cost, "
            "airdos_tpu/solvers/human_ba.py:188 residuals and :223 cost "
            "(static half)", _st_shape, _st_fmt,
            lambda shape: shape[0],
            _ba_check("static_edge_blocks",
                      lambda: _bst().static_edges_cuda,
                      lambda: _bst().static_edges_ref),
            _st_bound, _no_library),
    _Kernel("landmark_reduce", _bpt, "landmark_reduce_cuda",
            "reduce_launches", "airdos_tpu_torch/csrc/ba_points.cu",
            "airdos_tpu/solvers/local_ba.py:130 (damped inv3x3, Aagg)",
            _lr_shape, lambda shape: f"P={shape[0]} C={shape[1]}",
            lambda shape: shape[0] * shape[1],
            _ba_check("landmark_reduce", lambda: _bpt().landmark_reduce_cuda,
                      lambda: _bpt().landmark_reduce_ref),
            _lr_bound, _no_library),
    _Kernel("landmark_backsub", _bpt, "landmark_backsub_cuda",
            "backsub_launches", "airdos_tpu_torch/csrc/ba_points.cu",
            "airdos_tpu/solvers/local_ba.py:164 (back-substitution)",
            _lb_shape, lambda shape: f"P={shape[0]} C={shape[1]}",
            lambda shape: shape[0],
            _ba_check("landmark_backsub",
                      lambda: _bpt().landmark_backsub_cuda,
                      lambda: _bpt().landmark_backsub_ref),
            _lb_bound, _no_library),
    _Kernel("human_edge_blocks", _bhu, "human_edges_cuda", "launches",
            "airdos_tpu_torch/csrc/ba_human.cu",
            "airdos_tpu/solvers/human_ba.py:188 residuals, :257 gn_step "
            "(family weights, J_m, J_r, scatter products), :223 cost (the "
            "human families' sums)", _hu_shape,
            _hu_fmt, lambda shape: sum(shape[:3]), _hu_check,
            _hu_bound, _no_library, human_only=True),
    _Kernel("match_rows", _match, "match_rows_cuda", "launches",
            "airdos_tpu_torch/csrc/match.cu",
            "airdos_tpu/ops/pallas_kernels.py:43 (through :59 "
            "hamming_matrix_auto) with the epilogues of "
            "airdos_tpu/matching/stereo.py:88, "
            "airdos_tpu/matching/projection.py:81 and :130, "
            "airdos_tpu/matching/bow_match.py:31, "
            "airdos_tpu/matching/sim3_match.py:31, "
            "airdos_tpu/matching/fuse.py:27 (:69), "
            "airdos_tpu/matching/epipolar.py:36 (:63-84)", _mr_shape, _mr_fmt,
            lambda shape: shape[1] * shape[2] * shape[3], _mr_check,
            _mr_bound, _no_library),
    # the resolve runs inside match_rows' launch: its launches are the
    # match_rows launches that ran it, its times the whole launch's
    _Kernel("match_resolve", _match, "match_rows_cuda",
            "resolve_launches", "airdos_tpu_torch/csrc/match.cu",
            "airdos_tpu/matching/projection.py:61 _rotation_consistency, "
            ":41 _resolve_unique", _rs_shape, _rs_fmt,
            lambda shape: shape[1], _rs_check, _rs_bound, _no_library),
    _Kernel("triangulate", _tri, "triangulate_rows_cuda", "launches",
            "airdos_tpu_torch/csrc/triangulate.cu",
            "airdos_tpu/matching/epipolar.py:86-178 (triangulate_pair "
            "after its argmin)", _tri_shape, _tri_fmt,
            lambda shape: shape[0] * shape[1], _tri_check, _tri_bound,
            _no_library),
    _Kernel("schur_point", _bgl, "PointLaunch.__call__", "point_launches",
            "airdos_tpu_torch/csrc/ba_global.cu",
            "airdos_tpu/solvers/global_ba.py:113 schur_matvec (the gather, "
            "point-keyed scatter-add and Hpp^-1 of :115-118)", _sp_shape,
            _schur_fmt, lambda shape: shape[1], _sp_check, _sp_bound,
            _no_library, loop_only=True, view=_sp_view),
    _Kernel("schur_camera", _bgl, "CameraLaunch.__call__", "camera_launches",
            "airdos_tpu_torch/csrc/ba_global.cu",
            "airdos_tpu/solvers/global_ba.py:113 schur_matvec (the "
            "camera-keyed scatter-add and Hcc_d x of :119-122), :133 "
            "precond, :143 cg_body", _sc_shape, _schur_fmt,
            lambda shape: shape[2], _sc_check, _sc_bound, _no_library,
            loop_only=True, view=_sc_view),
    _Kernel("sim3_edges", _pgk, "sim3_edges_cuda", "launches",
            "airdos_tpu_torch/csrc/sim3_edges.cu",
            "airdos_tpu/solvers/pose_graph.py:27 _edge_residual, :59 "
            "edge_system (jacfwd), :77-78 J^T W J and J^T W e, :96 cost",
            _s3_shape, _s3_fmt, lambda shape: shape[1], _s3_check,
            _s3_bound, _no_library, loop_only=True),
    _Kernel("epnp_hypotheses", _rsk, "epnp_hypotheses_cuda",
            "epnp_hypotheses_launches", "airdos_tpu_torch/csrc/ransac.cu",
            "airdos_tpu/solvers/epnp.py:147 epnp_ransac (one_hyp :167, "
            "epnp_pose :90, its eigh :30 and :98)", _eh_shape, _hyp_fmt,
            lambda shape: shape[0] * shape[1], _eh_check, _eh_bound,
            _no_library, reloc_only=True),
    _Kernel("epnp_refine", _rsk, "epnp_refine_cuda", "epnp_refine_launches",
            "airdos_tpu_torch/csrc/ransac.cu",
            "airdos_tpu/solvers/epnp.py:171-185 (epnp_ransac's refine)",
            _er_shape, _refine_fmt, lambda shape: shape[0], _er_check,
            _er_bound, _no_library, reloc_only=True),
    _Kernel("horn_hypotheses", _rsk, "horn_hypotheses_cuda",
            "horn_hypotheses_launches", "airdos_tpu_torch/csrc/ransac.cu",
            "airdos_tpu/solvers/sim3.py:33 sim3_ransac (one_hyp :65), "
            "airdos_tpu/solvers/align.py:16 horn_align (eigh :47)",
            _hh_shape, _hyp_fmt, lambda shape: shape[0] * shape[1],
            _hh_check, _hh_bound, _no_library, loop_only=True),
    _Kernel("horn_refine", _rsk, "horn_refine_cuda", "horn_refine_launches",
            "airdos_tpu_torch/csrc/ransac.cu",
            "airdos_tpu/solvers/sim3.py:70-78 (sim3_ransac's refine)",
            _hr_shape, _refine_fmt, lambda shape: shape[0], _hr_check,
            _hr_bound, _no_library, loop_only=True),
    _Kernel("sim3_opt", _s3o, "sim3_opt_cuda", "launches",
            "airdos_tpu_torch/csrc/sim3_opt.cu",
            "airdos_tpu/solvers/sim3.py:82 optimize_sim3 (its two "
            "lax.fori_loops of jacfwd Gauss-Newton steps)", _so_shape,
            _so_fmt, lambda shape: shape[0], _so_check, _so_bound,
            _no_library, graph_n=20, loop_only=True),
    _Kernel("voc_transform", _voc, "voc_transform_cuda", "launches",
            "airdos_tpu_torch/csrc/voc_transform.cu",
            "airdos_tpu/bow/vocabulary.py:75 _transform_device", _vt_shape,
            _vt_fmt, lambda shape: shape[0], _vt_check, _vt_bound,
            _no_library, variants=_vt_variants),
)

# the BA kernels' launches per solve of the static (local) BA and of the
# human BA, from solvers/local_ba.py's and solvers/human_ba.py's
# docstrings: 15 Gauss-Newton steps, 17 LM costs (the static family's
# summed in static_edge_blocks' cost-sum mode, the human families' in
# human_edge_blocks') and 2 chi-square passes (segment_sum's 45 and 60 are
# checked on their own)
STATIC_SOLVE = {"static_edge_blocks": 34, "landmark_reduce": 15,
                "landmark_backsub": 15}
HUMAN_SOLVE = {"static_edge_blocks": 34, "human_edge_blocks": 34,
               "landmark_reduce": 15, "landmark_backsub": 15}


def _per_solve_off(per, static: str, human: str = ""):
    """The frames whose launches of the BA kernels are not STATIC_SOLVE a
    static BA solve plus HUMAN_SOLVE a human one: [(frame, kernel, got,
    want)]."""
    off = []
    for i, p in enumerate(per):
        n_s, n_h = p[static], p[human] if human else 0
        for k in STATIC_SOLVE.keys() | HUMAN_SOLVE.keys():
            want = STATIC_SOLVE.get(k, 0) * n_s + HUMAN_SOLVE.get(k, 0) * n_h
            if p["d"][k] != want:
                off.append((i, k, p["d"][k], want))
    return off


def _reset_counts() -> None:
    for module in _MODULES:
        module().reset_launches()


def _counts() -> dict:
    """Each kernel's launches, and match_rows' launches in fuse and in
    epipolar mode ("match_fuse", "match_epipolar", not kernels of their
    own)."""
    counts = {k.name: getattr(k.module(), k.launches)() for k in KERNELS}
    counts["match_fuse"] = _match().fuse_launches()
    counts["match_epipolar"] = _match().epipolar_launches()
    return counts


@contextlib.contextmanager
def _call_watch(module, name, launches, on_call=None):
    """Every call of module.name made while the context is open ->
    [(each of `launches`' counts over the call)], a call each; on_call
    sees each call's arguments."""
    fn = getattr(module, name)
    calls = []

    def watched(*args, **kwargs):
        c0 = [count() for count in launches]
        out = fn(*args, **kwargs)
        calls.append(tuple(count() - c for count, c in zip(launches, c0)))
        if on_call is not None:
            on_call(args)
        return out

    setattr(module, name, watched)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _triangulation_watch():
    """Every triangulation call (ba_driver's triangulate_pair) -> [(match_rows
    launches in epipolar mode, triangulate launches, Hamming launches 2-D
    and batched)], a call each; each path's first inputs at a shape kept
    for the kernel phase."""
    from airdos_tpu_torch.slam import ba_driver
    mk, tk, hk = _match(), _tri(), _hamming()

    def keep(args):
        B, N1, N2 = args[8].shape[0], args[0].shape[0], args[8].shape[1]
        if (B, N1, N2) not in _FOR_TRI:
            _FOR_TRI[(B, N1, N2)] = tuple(_cloned(a) for a in args)

    return _call_watch(ba_driver, "triangulate_pair",
                       (mk.epipolar_launches, tk.launches,
                        lambda: hk.launches() + hk.batched_launches()), keep)


def _fusion_watch():
    """Every call of fusion's device match (ba_driver's fuse_candidates:
    a keyframe's neighbourhood fusion and the loop's SearchAndFuse) ->
    [(match_rows launches in fuse mode, batched Hamming launches)], a call
    each."""
    from airdos_tpu_torch.slam import ba_driver
    mk, hk = _match(), _hamming()
    return _call_watch(ba_driver, "fuse_candidates",
                       (mk.fuse_launches, hk.batched_launches))


def _sim3_watch():
    """Every call of the loop's Sim3 match (loop_closing's match_by_sim3)
    -> [(match_rows launches, Hamming launches 2-D and batched)], a call
    each."""
    from airdos_tpu_torch.slam import loop_closing
    mk, hk = _match(), _hamming()
    return _call_watch(loop_closing, "match_by_sim3",
                       (mk.launches,
                        lambda: hk.launches() + hk.batched_launches()))


def _own(tally, name):
    """name's launches from the calling thread so far: online mode's
    threads launch at once, so a call's launches are its own thread's."""
    def count():
        me = threading.current_thread().name
        return sum(n for (k, th, _), n in tally().items()
                   if k == name and th == me)
    return count


@contextlib.contextmanager
def _geometry_watch():
    """Every relocalization RANSAC (tracking's epnp_ransac: the single-
    device one), loop closing's Sim3 RANSAC and OptimizeSim3, and every
    Vocabulary.transform -> {what: [(its kernels' launches from the
    calling thread over the call)], a call each}."""
    from airdos_tpu_torch.bow.vocabulary import Vocabulary
    from airdos_tpu_torch.slam import loop_closing, tracking
    rk, so, vk = _rsk(), _s3o(), _voc()
    with _call_watch(tracking, "epnp_ransac",
                     (_own(rk.launch_tally, "epnp_hypotheses"),
                      _own(rk.launch_tally, "epnp_refine"))) as pnp, \
            _call_watch(loop_closing, "sim3_ransac",
                        (_own(rk.launch_tally, "horn_hypotheses"),
                         _own(rk.launch_tally, "horn_refine"))) as sim3, \
            _call_watch(loop_closing, "optimize_sim3",
                        (_own(so.launch_tally, "sim3_opt"),)) as opt, \
            _call_watch(Vocabulary, "transform",
                        (_own(vk.launch_tally, "voc_transform"),)) as voc:
        yield {"EPnP RANSAC": (pnp, (1, 1)), "Sim3 RANSAC": (sim3, (1, 1)),
               "OptimizeSim3": (opt, (1,)), "Vocabulary.transform":
               (voc, (1,))}


def _geometry_off(watched) -> list:
    """The calls of _geometry_watch that did not launch their kernels once
    each (EPnP: hypotheses and refine; Sim3: Horn's two modes;
    OptimizeSim3: sim3_opt; transform: voc_transform), or a kind with no
    call: [(what, call, launches)]."""
    off = []
    for what, (calls, want) in watched.items():
        if not calls:
            off.append((what, None, None))
        off += [(what, i, c) for i, c in enumerate(calls) if c != want]
    return off


def _triangulation_off(calls) -> list:
    """The triangulation calls that did not launch exactly one match_rows
    in epipolar mode, one triangulate and no Hamming kernel."""
    return [(i, c) for i, c in enumerate(calls) if c != (1, 1, 0)]


def _fusion_off(calls) -> list:
    """The fusion calls that did not launch exactly one match_rows in fuse
    mode and no batched Hamming kernel: [(call, (fuse, batched))]."""
    return [(i, c) for i, c in enumerate(calls) if c != (1, 0)]


def _bound(k: _Kernel, shape, args):
    """The least time (ms) the card could take for one call at `shape` on
    these inputs, what bounds it and the bytes: the larger of the bytes
    the function must move (each input read once, the output written
    once) over the HBM rate and its operations over the peak rate for
    their type (each kernel's bound function says what it counts)."""
    nbytes, t_ops = k.bound(shape, args)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test needs a "
              "CUDA device and has no CPU fallback")
    smi = _nvidia_smi()
    print(f"[env] gpu: {smi}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
          f"nvcc {shutil.which('nvcc') or 'not on PATH'}", flush=True)
    return smi


def phase_build():
    mods = [module() for module in _MODULES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source, at once
        paths = list(pool.map(lambda mod: mod.build(), mods))
    print(f"[build] {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _cloned(x):
    """A recorded argument: tensors (also inside a plain tuple or list, as
    the pyramid levels and detection maps come, or a named tuple of
    tensors, as the matchers' rows and columns) cloned; a named tuple that
    holds anything else (the human BA's LaunchTables keep their tables'
    device pointers) is kept as it is."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if type(x) in (tuple, list):
        return type(x)(_cloned(y) for y in x)
    if isinstance(x, tuple) and hasattr(x, "_fields") and all(
            y is None or isinstance(y, torch.Tensor) for y in x):
        return type(x)(*(_cloned(y) for y in x))
    return x


def _path_recording():
    """A context in which every launch of the port's kernels is also
    recorded by shape in _PATH, with the first inputs of each shape, so
    that the kernel phase can hold each kernel against its plain version
    on the inputs the main path gave it.  The launch counts are the
    wrappers' own and unchanged."""
    groups = {}                     # kernels recorded at one wrapper
    for k in KERNELS:
        groups.setdefault((k.module, k.wrapper), []).append(k)
    saved = []
    for (module, wrapper), ks in groups.items():
        owner = module()            # a dotted wrapper: a class's method
        *path, attr = wrapper.split(".")
        for name in path:
            owner = getattr(owner, name)
        saved.append((owner, attr, ks, getattr(owner, attr)))
    lock = threading.Lock()         # online phases launch from threads

    def recorder(launch, ks):
        def record(*args, **kwargs):
            with lock:
                for k in ks:
                    view = args if k.view is None else k.view(*args,
                                                               **kwargs)
                    shape = k.shape_of(*view)
                    if shape is None:       # not this kernel's launch
                        continue
                    entry = _PATH.setdefault(k.name, {}).setdefault(
                        shape, [0, None])
                    entry[0] += 1
                    if entry[1] is None:
                        entry[1] = tuple(_cloned(x) for x in view)
            return launch(*args, **kwargs)
        return record

    @contextlib.contextmanager
    def recording():
        for owner, attr, ks, launch in saved:
            setattr(owner, attr, recorder(launch, ks))
        try:
            yield
        finally:
            for owner, attr, ks, launch in saved:
                setattr(owner, attr, launch)
    return recording()


def _fmt_ms(ms) -> str:
    return f"{ms:.4f} ms" if ms is not None else "not measured"


def _share(bound_ms, dev_ms) -> str:
    return f"{bound_ms / dev_ms:.3g}" if dev_ms and dev_ms > 0 \
        else "not measured"


def phase_kernel(smi: str):
    """Each kernel against its plain version: the 2-D Hamming kernel at
    three fixed shapes of random words, then every kernel at every shape
    the main paths launched it with, on the first inputs the path gave it
    at that shape, beside its bound and one library call.  Device times
    come from CUDA events around a CUDA graph of many launches
    (_graph_ms); the first fixed shape is also read by torch.profiler, the
    reading the graph timing supersedes, for comparison.  Returns per
    kernel the max abs err over all checks and the measurements at its
    most launched path shape."""
    import torch
    hk = _hamming()
    rng = np.random.default_rng(SEED)
    errs = {}
    for i, (n, m) in enumerate(((1536, 1536), (2048, 1536), (1500, 1337))):
        a, b = _words(rng, (n, 8)), _words(rng, (m, 8))
        got = hk.hamming_matrix(a, b)
        want = hk.hamming_matrix_ref(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if got.shape != (n, m) or not torch.equal(got, want):
            _fail(f"kernel != plain version at {n}x{m} (max abs err {err})")
        ms = _cuda_ms(lambda: hk.hamming_matrix(a, b))
        plain_ms = _cuda_ms(lambda: hk.hamming_matrix_ref(a, b))
        cold, hot = _graph_ms(lambda: hk.hamming_matrix(a, b))
        prof = ""
        if i == 0:
            prof = (f", torch.profiler (mean of 20) "
                    f"{_fmt_ms(_device_ms(lambda: hk.hamming_matrix(a, b), 'hamming_kernel'))}")
        bound_ms, bound_by, _ = _bound(KERNELS[0], (1, 1, n, m), None)
        print(f"[kernel] hamming {n}x{m} random words: exact; per call kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, median of "
              f"20 x 10 back-to-back calls); kernel device time (CUDA graph "
              f"of 100) L2 cold {cold:.4f} ms, hot {hot:.4f} ms{prof}; bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}), device share of bound "
              f"{_share(bound_ms, cold)} on {smi}", flush=True)

    out = {}
    for k in KERNELS:
        name = k.name
        shapes = _PATH.get(name, {})
        if not shapes and not k.off_path:
            _fail(f"{name}: no launch recorded on the main paths")
        if k.variants is not None:
            shapes = {**shapes, **{sh: [0, args] for sh, args
                                   in k.variants(shapes).items()}}
        # the most launched shape first; ties go to the larger output
        order = sorted(shapes, key=lambda sh: (-shapes[sh][0],
                                               -k.out_size(sh)))
        for i, shape in enumerate(order):
            n_launch, args = shapes[shape]
            err, what, kernel, plain = k.check(args)
            errs[name] = max(errs.get(name, err), err)
            library, lib_name = k.library(args)
            ms, plain_ms = _cuda_ms(kernel), _cuda_ms(plain)
            lib_ms = _cuda_ms(library) if library is not None else None
            cold, hot = _graph_ms(kernel, n=k.graph_n)
            bound_ms, bound_by, nbytes = _bound(k, shape, args)
            if i == 0:
                out[name] = dict(ms=ms, plain_ms=plain_ms, device_ms=cold,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=lib_ms)
            lib = f"{lib_name} {_fmt_ms(lib_ms)}" if lib_ms is not None \
                else lib_name
            on_path = (f"{n_launch} launches on the main paths, on the "
                       f"path's inputs" if n_launch else
                       "not launched on the main paths, on a case built from a "
                       "path's inputs")
            print(f"[kernel] {name} {k.fmt(shape)}, {on_path}: {what}; "
                  f"per call kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {lib}; kernel device time (CUDA graph) L2 cold "
                  f"{cold:.4f} ms, hot {hot:.4f} ms; bound "
                  f"{bound_ms * 1e3:.3f} us ({bound_by}: {nbytes / 1e6:.3f} "
                  f"MB at 3.35 TB/s), device share of bound "
                  f"{_share(bound_ms, cold)} on {smi}", flush=True)
    return {name: dict(max_abs_err=errs[name], **row)
            for name, row in out.items()}


def _bench_config():
    """bench.py's _cfg(False): the static reference budget."""
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import default_camera
    cfg = SlamConfig()
    cfg.camera = default_camera()
    cfg.orb.n_features = 1500
    cfg.orb.n_levels = 8
    cfg.device.max_keypoints = 2048
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 2048
    cfg.device.max_ba_edges = 8192
    return cfg


def _small_config():
    """tests/test_system_e2e.py's small_config."""
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import small_camera
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    return cfg


def _human_bench_config():
    """bench.py's _cfg(True): the flagship's budgets, offline."""
    cfg = _bench_config()
    cfg.human.ok = True
    cfg.human.is_seg = True
    cfg.system.is_mask = True
    cfg.camera.fps = 5.0
    cfg.device.max_trajectories = 8
    cfg.device.max_trajectory_len = 8
    return cfg


def _polluted_config():
    """bench.py's cfg_polluted: the static pipeline, no mask, on the crowd
    frames."""
    cfg = _bench_config()
    cfg.camera.fps = 5.0
    return cfg


def _small_human_config():
    """The human System of tests/test_torch_human_system.py: the small
    camera, masked, Camera.fps 3 (a human BA every 3 frames)."""
    cfg = _small_config()
    cfg.human.ok = True
    cfg.human.is_seg = True
    cfg.system.is_mask = True
    cfg.camera.fps = 3.0
    cfg.device.max_trajectories = 2
    cfg.device.max_trajectory_len = 16
    return cfg


def _small_human_frames(n: int):
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    world = SyntheticStereoWorld(seed=3, n_points=200,
                                 cam=_small_human_config().camera, n_humans=2)
    return [d for d, _, _ in world.sequence(n, dt=0.1, yaw_rate=0.008)]


def _crowd_frames(n: int):
    """bench.py sections 2-3's crowd scene at 640x360 with the humans
    rendered, and its ground truth camera centres."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(seed=2, n_points=500, n_humans=10,
                                 crowd=True)
    Rwc, twc = world.trajectory(n, 0.1, yaw_rate=0.005)
    frames = _render(world, Rwc, twc, 0.1, True)
    print(f"[frames] rendered {n} crowd frames 640x360 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, twc


def _render_one(i):
    world, Rwc, twc, dt, humans = _RENDER["job"]
    return world.frame(i, Rwc[i], twc[i], i * dt, with_humans=humans)


def _render(world, Rwc, twc, dt, humans):
    """Render every pose of a trajectory in a pool of forked processes
    (numpy only; started before any CUDA context exists, and stopped on
    return)."""
    _RENDER["job"] = (world, Rwc, twc, dt, humans)
    n_proc = max(1, min(8, os.cpu_count() or 1))
    with multiprocessing.get_context("fork").Pool(n_proc) as pool:
        frames = pool.map(_render_one, range(len(Rwc)))
    _RENDER.clear()
    return frames


def _small_frames(n: int):
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    cfg = _small_config()
    world = SyntheticStereoWorld(seed=SEED, n_points=200, cam=cfg.camera)
    return [d for d, _, _ in world.sequence(n, dt=0.1, yaw_rate=0.008)]


def _bench_frames(n: int):
    """bench.py section 1's static frames at 640x360, and their ground
    truth camera centres."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(seed=SEED, n_points=500)
    Rwc, twc = world.trajectory(n, 0.1, speed=0.3, yaw_rate=0.005)
    frames = _render(world, Rwc, twc, 0.1, False)
    print(f"[frames] rendered {n} frames 640x360 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, twc


def _orbit_frames(n: int):
    """tests/test_loop_closure.py's pillar orbit at 640x360: the camera
    circles a textured octagonal pillar 1.22 times."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(
        seed=1, n_points=300, centered=True, world_size=(16.0, 3.0, 16.0),
        clear_ring=(1.35, 0.0, 1.35, 0.7), ring_outside_only=True,
        room_radius=4.5, pillar=(1.35, 0.0, 0.55, 8))
    Rwc, twc = world.orbit_loop_trajectory(n, radius=1.35, laps=1.22)
    frames = _render(world, Rwc, twc, 0.2, False)
    print(f"[frames] rendered {n} pillar-orbit frames 640x360 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, twc


def _sync() -> None:
    import torch
    torch.cuda.synchronize()


def _run(slam, frames):
    """Track frames with a System; per frame (state, branch, seconds)."""
    per = []
    track = slam.track_stereo_human if slam.config.human.ok \
        else slam.track_stereo
    for data in frames:
        t0 = time.perf_counter()
        track(data)
        _sync()
        per.append((slam.tracking.state.name, slam.tracking.last_branch,
                    time.perf_counter() - t0))
    slam.shutdown()
    return per


def _ate(trk, twc):
    from airdos_tpu_torch.io.tum import ate_rmse
    _, R_est, t_est = trk.trajectory_tum()
    if t_est.shape != (len(twc), 3) or not np.isfinite(t_est).all() \
            or not np.isfinite(R_est).all():
        _fail(f"trajectory shape {t_est.shape} or non-finite poses")
    return ate_rmse(t_est, twc[:len(t_est)])


# the front end's launches a frame: one pyramid, FAST + NMS, select and
# orb_desc launch an image of the stereo pair (each over all the image's
# levels) and one stereo_sad
FRONT_END = dict(pyramid=2, fast_nms=2, select=2, orb_desc=2, stereo_sad=1)
# a fused ("fast") frame's matchers: the stereo, motion-model and
# local-map match_rows (a fourth with the x2-window retry), the motion
# and local ones with the resolve in their launch (match_resolve counts
# those: csrc/match.cu has no kernel of its own for it, where a separate
# match_resolve launched 2 more), and no 2-D Hamming kernel (no path
# launches it)
FUSED_MATCH = dict(match_rows=3, match_resolve=2)


def _fused_match_off(per) -> list:
    """[(frame, {kernel: launches})] of the fused frames in per, [(branch,
    launches)], whose matchers did not run on FUSED_MATCH alone."""
    return [(i, {k: d[k] for k in (*FUSED_MATCH, "hamming_matrix")})
            for i, (branch, d) in enumerate(per) if branch == "fast"
            and (any(d[k] < n for k, n in FUSED_MATCH.items())
                 or d["hamming_matrix"])]


def _front_end_off(launches) -> list:
    """The frames whose launches (a {kernel: launches} a frame) are not
    FRONT_END's."""
    return [i for i, d in enumerate(launches)
            if any(d[k] != n for k, n in FRONT_END.items())]


def _ms_stats(ms) -> str:
    ms = np.asarray(ms)
    if not len(ms):
        return "none"
    return f"median {np.median(ms):.2f} p90 {np.percentile(ms, 90):.2f}"


def phase_slice(smi: str, frames, twc):
    """Tracking only: airdos_tpu's Tracking(..., local_mapper=None)."""
    from airdos_tpu_torch.slam.frame import FrontEnd
    from airdos_tpu_torch.slam.map import SlamMap
    from airdos_tpu_torch.slam.tracking import Tracking
    from airdos_tpu_torch.utils.obs import Profiler

    cfg = _bench_config()
    trk = Tracking(cfg, FrontEnd(cfg, device="cuda"), SlamMap(),
                   local_mapper=None)
    trk.profiler = Profiler()
    per = []
    _reset_counts()
    for data in frames:
        before = _counts()
        t0 = time.perf_counter()
        trk.track(data)
        _sync()
        dt = time.perf_counter() - t0
        after = _counts()
        per.append((trk.state.name, trk.last_branch, dt,
                    {k: after[k] - before[k] for k in after}))
    counts = _counts()
    for i, (state, branch, dt, d) in enumerate(per):
        print(f"[slice] frame {i:2d} {state} {branch:5s} {dt * 1e3:9.2f} ms "
              f"launches: match_rows {d['match_rows']} ({d['match_resolve']} "
              f"with the resolve), 2-D hamming {d['hamming_matrix']}, "
              f"pose_lm {d['pose_lm']}, pyramid {d['pyramid']}, fast_nms "
              f"{d['fast_nms']}, select {d['select']}, orb_desc "
              f"{d['orb_desc']}, stereo_sad {d['stereo_sad']}")
    bad = [i for i, p in enumerate(per) if p[0] != "OK"]
    if bad:
        _fail(f"tracking-only frames not OK: {bad}")
    fast = [p for p in per if p[1] == "fast"]
    if not fast:
        _fail("no frame took the fused (fast) branch")
    few = [i for i, p in enumerate(per)
           if p[1] == "fast" and p[3]["pose_lm"] < 2]
    if few:
        _fail(f"fast frames with < 2 pose_lm kernel launches: {few}")
    match_off = _fused_match_off([(p[1], p[3]) for p in per])
    if match_off:
        _fail(f"fast frames without {FUSED_MATCH} matcher launches or with "
              f"2-D Hamming launches: {match_off}")
    off = _front_end_off([p[3] for p in per])
    if off:
        _fail(f"frames without {FRONT_END} front-end launches (the "
              f"pyramid and FAST + NMS one launch an image, not one a "
              f"level): {off}")
    n_kfs = trk.map.n_keyframes()
    if n_kfs < 5:
        _fail(f"tracking only: {n_kfs} keyframes")
    ate = _ate(trk, twc)
    if not ate < 0.02:
        _fail(f"tracking only: ATE {ate} m >= 0.02 m")
    branches = [p[1] for p in per]
    print(f"[slice] branches {branches[0]} -> {branches[1]} -> "
          f"fast x{branches.count('fast')}; keyframes {n_kfs}; map points "
          f"{trk.map.n_points()}; ATE {ate:.6f} m; launches {counts}")
    print(f"[slice] per-frame ms all frames: "
          f"{_ms_stats([p[2] * 1e3 for p in per])}; fast frames: "
          f"{_ms_stats([p[2] * 1e3 for p in fast])} on {smi}", flush=True)
    stages = trk.profiler.report()
    print("[slice] host stages (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f}" for k, v in sorted(stages.items())))
    return counts


def _trajectory_bytes(slam, kind: str) -> bytes:
    """The bytes of a System's trajectory file, KITTI or TUM."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "traj.txt"
        (slam.save_trajectory_kitti if kind == "kitti"
         else slam.save_trajectory_tum)(path)
        return path.read_bytes()


def _track_static(slam, frames):
    """Track frames with a static System; per frame its state, branch,
    milliseconds, whether it made a keyframe, the live keyframes before
    it, its BA solves and its kernel launches."""
    per = []
    for data in frames:
        c0, s0 = _counts(), slam.static_ba.n_solves
        live0 = slam.map.n_keyframes()
        t0 = time.perf_counter()
        slam.track_stereo(data)
        _sync()
        dt = time.perf_counter() - t0
        c1 = _counts()
        kf = slam.map.kfs.get(slam.tracking.last_kf_id)
        is_kf = kf is not None and kf.frame_id == data.index
        per.append(dict(state=slam.tracking.state.name,
                        branch=slam.tracking.last_branch, ms=dt * 1e3,
                        kf=is_kf, live0=live0,
                        solves=slam.static_ba.n_solves - s0,
                        d={k: c1[k] - c0[k] for k in c1}))
    return per


def _track_human(slam, frames):
    """Track frames with a human System; per frame its state, branch,
    milliseconds, keyframe, static and human BA solves, whether the human
    BA cadence ticked, its humans and its kernel launches."""
    per = []
    for data in frames:
        c0, s0 = _counts(), slam.static_ba.n_solves
        h0, tick0 = slam.human_ba.n_runs, slam._last_human_ba_frame
        t0 = time.perf_counter()
        slam.track_stereo_human(data)
        _sync()
        dt = time.perf_counter() - t0
        c1 = _counts()
        kf = slam.map.kfs.get(slam.tracking.last_kf_id)
        per.append(dict(state=slam.tracking.state.name,
                        branch=slam.tracking.last_branch, ms=dt * 1e3,
                        kf=kf is not None and kf.frame_id == data.index,
                        static=slam.static_ba.n_solves - s0,
                        human=slam.human_ba.n_runs - h0,
                        tick=slam._last_human_ba_frame != tick0,
                        humans=len(slam.tracking.last_frame.humans),
                        d={k: c1[k] - c0[k] for k in c1}))
    return per


def phase_mapping(smi: str, frames, twc, twins):
    """The offline System with the mapping pass at the bench budgets; its
    KITTI trajectory goes to twins["kitti"], the in-memory twin of phase
    14a's KITTI driver."""
    from airdos_tpu_torch.slam import ba_driver
    from airdos_tpu_torch.slam.system import System

    solver = ba_driver.local_bundle_adjust

    def recorded(*args, **kwargs):
        _FOR_MESH.setdefault("static_ba", tuple(
            a.clone() if hasattr(a, "clone") else a for a in args))
        return solver(*args, **kwargs)

    slam = System(_bench_config(), device="cuda")
    _reset_counts()
    ba_driver.local_bundle_adjust = recorded
    try:
        with _fusion_watch() as fusions:
            per = _track_static(slam, frames)
    finally:
        ba_driver.local_bundle_adjust = solver
    counts = _counts()
    slam.shutdown()
    twins["kitti"] = _trajectory_bytes(slam, "kitti")
    for i, p in enumerate(per):
        print(f"[mapping] frame {i:2d} {p['state']} {p['branch']:5s} "
              f"{'KF' if p['kf'] else '  '} {p['ms']:9.2f} ms BA solves "
              f"{p['solves']} launches {p['d']}")
    bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
    if bad:
        _fail(f"mapping frames not OK: {bad}")
    kf_frames = [i for i, p in enumerate(per) if p["kf"]]
    n_inserted = len(slam.map.kfs)
    if n_inserted < 5:
        _fail(f"mapping: only {n_inserted} keyframes inserted")
    ate = _ate(slam.tracking, twc)
    if not ate < 0.02:
        _fail(f"mapping: ATE {ate} m >= 0.02 m")
    _FOR_MESH["mapping_ate"] = ate
    n_created = slam.local_mapper.triangulator.n_created
    if n_created <= 0:
        _fail("mapping: triangulation created no map points")
    no_ba = [i for i in kf_frames if per[i]["live0"] >= 2
             and per[i]["solves"] != 1]
    if no_ba:
        _fail(f"mapping: no static BA solve at keyframe frames {no_ba}")
    # triangulation: one epipolar match_rows and one triangulate launch
    # at each keyframe with a neighbour past the stereo baseline (the
    # early keyframes, a few cm apart, have none and launch nothing; the
    # paths' triangulation watch holds each call to one of each), none
    # elsewhere; no path launches the Hamming kernel
    tri = {i: (p["d"]["match_epipolar"], p["d"]["triangulate"])
           for i, p in enumerate(per)}
    tri_off = [(i, t) for i, t in tri.items()
               if t not in ((0, 0), (1, 1)) or (t == (1, 1) and i not in
                                                kf_frames[1:])]
    if tri_off or not any(t == (1, 1) for t in tri.values()):
        _fail(f"mapping: frames (frame, (epipolar match_rows, triangulate "
              f"launches)) {tri_off} not one of each at a keyframe and none "
              f"elsewhere, or no keyframe triangulated")
    no_fuse = [i for i in kf_frames[1:] if per[i]["d"]["match_fuse"] < 1]
    fusion_off = _fusion_off(fusions)
    if no_fuse or fusion_off or not fusions:
        _fail(f"mapping: keyframe frames {no_fuse} without a match_rows "
              f"launch in fuse mode, or fusion calls (call, (fuse-mode "
              f"match_rows, batched Hamming launches)) {fusion_off} not "
              f"(1, 0), of {len(fusions)}")
    print(f"[mapping] fusion: {len(fusions)} calls, each one match_rows "
          f"launch in fuse mode and no batched Hamming kernel; "
          f"triangulation at keyframe frames "
          f"{[i for i, t in tri.items() if t == (1, 1)]}, one epipolar "
          f"match_rows and one triangulate launch each", flush=True)
    seg_off = [i for i, p in enumerate(per)
               if p["d"]["segment_sum"] != 45 * p["solves"]]
    if seg_off:
        _fail(f"mapping: segment_sum launches != 45 per BA solve at frames "
              f"{seg_off}")
    fe_off = _front_end_off([p["d"] for p in per])
    if fe_off:
        _fail(f"mapping: frames without {FRONT_END} front-end launches: "
              f"{fe_off}")
    match_off = _fused_match_off([(p["branch"], p["d"]) for p in per])
    if match_off:
        _fail(f"mapping: fast frames without {FUSED_MATCH} matcher launches "
              f"or with 2-D Hamming launches: {match_off}")
    ba_off = _per_solve_off(per, "solves")
    if ba_off:
        _fail(f"mapping: BA kernel launches per solve != {STATIC_SOLVE} at "
              f"(frame, kernel, launches, expected) {ba_off[:8]}")
    not_here = {k.name for k in KERNELS if k.human_only or k.loop_only
                or k.reloc_only or k.off_path}
    idle = [k for k, v in counts.items() if v <= 0 and k not in not_here]
    if idle:
        _fail(f"mapping: kernels never launched on the main path: {idle}")
    track_ms = [p["ms"] for p in per if not p["kf"]]
    kf_ms = [p["ms"] for i, p in enumerate(per) if p["kf"] and i > 0]
    print(f"[mapping] keyframes inserted {n_inserted} (frames {kf_frames}), "
          f"live {slam.map.n_keyframes()}; map points {slam.map.n_points()}; "
          f"triangulated {n_created}; BA solves {slam.static_ba.n_solves}; "
          f"ATE {ate:.6f} m; launches {counts}")
    print(f"[mapping] per-frame ms tracking frames: {_ms_stats(track_ms)}; "
          f"keyframe frames after the first: {_ms_stats(kf_ms)} on {smi}",
          flush=True)
    stages = slam.profiler.report()
    print("[mapping] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']})"
        for k, v in sorted(stages.items())
        if k.startswith("map.") or k.startswith("ba.")), flush=True)
    _write_back_split(slam)
    return counts


# the three refreshes of the fusion's write-back under the map lock
WRITE_BACK = ("map.descriptors", "map.normals", "map.connections")


def _unpackbits_descriptor(D) -> int:
    """The per-point distinctive descriptor that the batch replaced: one
    np.unpackbits pass over a point's [n, n] xor words."""
    x = D[:, None, :] ^ D[None, :, :]
    dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    return int(np.argmin(np.sort(dist, axis=1)[:, (len(D) - 1) // 2]))


def _write_back_split(slam) -> None:
    """The fusion write-back's split (Fuser's spans, median ms a
    keyframe), and on the final map, for each live keyframe's points, the
    batched descriptor refresh (SlamMap.update_point_descriptors, one
    native call) against the per-point np.unpackbits loop it replaced,
    host ms a keyframe: the same descriptors, or the phase fails."""
    stages = slam.profiler.report()
    missing = [k for k in WRITE_BACK if k not in stages]
    if missing:
        _fail(f"mapping: no {missing} span in the fusion's write-back")
    m = slam.map
    pt = m.points
    saved = pt.desc32.copy()
    batched, loop = [], []
    for kf in m.kfs.values():
        if kf.bad:
            continue
        pids = [int(p) for p in kf.mp_idx[kf.mp_idx >= 0]
                if not pt.bad[int(p)]]
        t0 = time.perf_counter()
        m.update_point_descriptors(pids)
        t1 = time.perf_counter()
        want = {}
        for p in pids:
            descs = m._live_descriptors(p)
            if descs:
                D = np.asarray(descs)
                want[p] = D[_unpackbits_descriptor(D)]
        batched.append((t1 - t0) * 1e3)
        loop.append((time.perf_counter() - t1) * 1e3)
        off = [p for p, d in want.items() if not np.array_equal(pt.desc32[p],
                                                                d)]
        if off:
            _fail(f"mapping: batched descriptors differ from the per-point "
                  f"loop's at points {off[:8]}")
    pt.desc32[:] = saved
    print("[mapping] fusion write-back (median ms a keyframe): " + ", ".join(
        f"{k} {stages[k]['median_s'] * 1e3:.3f} (n {stages[k]['n']})"
        for k in WRITE_BACK) + f"; descriptor refresh of each of the "
        f"{len(batched)} live keyframes' points on the final map, host ms "
        f"a keyframe: batched {_ms_stats(batched)}, the per-point "
        f"np.unpackbits loop {_ms_stats(loop)}, the same descriptors",
        flush=True)


def _reduced_dim(args) -> int:
    """The human BA's reduced dimension from its arguments: 6 C + 3 T L 14
    + 14 T + 6 T (cameras, joints, limb lengths, motions)."""
    C = args[0].shape[0]
    T, L = args[10].shape[:2]
    return 6 * C + 42 * T * L + 20 * T


def phase_human(smi: str, frames, twc, twins):
    """The flagship System (bench.py _cfg(True), offline) and the polluted
    static System on the crowd frames; the flagship's TUM trajectory goes
    to twins["tartanair"], the in-memory twin of phase 14b's driver."""
    from airdos_tpu_torch.slam import ba_driver
    from airdos_tpu_torch.slam.system import System

    dims = []
    solver = ba_driver.human_bundle_adjust

    def recorded(*args, **kwargs):
        dims.append(_reduced_dim(args))
        return solver(*args, **kwargs)

    slam = System(_human_bench_config(), device="cuda")
    ba_driver.human_bundle_adjust = recorded
    try:
        _reset_counts()
        per = _track_human(slam, frames)
        counts = _counts()
    finally:
        ba_driver.human_bundle_adjust = solver
    slam.shutdown()
    twins["tartanair"] = _trajectory_bytes(slam, "tum")
    for i, p in enumerate(per):
        print(f"[human] frame {i:2d} {p['state']} {p['branch']:5s} "
              f"{'KF' if p['kf'] else '  '} {'HBA' if p['human'] else '   '} "
              f"{p['ms']:9.2f} ms humans {p['humans']} BA solves static "
              f"{p['static']} human {p['human']} launches {p['d']}")
    bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
    if bad:
        _fail(f"human: flagship frames not OK: {bad}")
    n_opt = sum(t.optimized for t in slam.map.trajectories.values())
    if n_opt < 1:
        _fail("human: no long trajectory optimized")
    missed = [i for i, p in enumerate(per) if p["tick"] and p["human"] != 1]
    if missed or not any(p["tick"] for p in per):
        _fail(f"human: no human BA solve at cadence ticks {missed}")
    seg_off = [i for i, p in enumerate(per) if p["d"]["segment_sum"]
               != 45 * p["static"] + 60 * p["human"]]
    if seg_off:
        _fail(f"human: segment_sum launches != 45 per static and 60 per "
              f"human BA solve at frames {seg_off}")
    fe_off = _front_end_off([p["d"] for p in per])
    if fe_off:
        _fail(f"human: flagship frames without {FRONT_END} front-end "
              f"launches: {fe_off}")
    match_off = _fused_match_off([(p["branch"], p["d"]) for p in per])
    if match_off:
        _fail(f"human: fast frames without {FUSED_MATCH} matcher launches "
              f"or with 2-D Hamming launches: {match_off}")
    ba_off = _per_solve_off(per, "static", "human")
    if ba_off:
        _fail(f"human: BA kernel launches != {STATIC_SOLVE} per static and "
              f"{HUMAN_SOLVE} per human BA solve at (frame, kernel, "
              f"launches, expected) {ba_off[:8]}")
    not_here = {k.name for k in KERNELS
                if k.loop_only or k.reloc_only or k.off_path}
    idle = [k for k, v in counts.items() if v <= 0 and k not in not_here]
    if idle:
        _fail(f"human: kernels never launched on the main path: {idle}")
    ate_human = _ate(slam.tracking, twc)
    _FOR_MESH["human_ate"] = ate_human
    spans = slam.profiler.report()

    static = System(_polluted_config(), device="cuda")
    _run(static, frames)
    ate_static = _ate(static.tracking, twc)
    print(f"[human] crowd-{len(frames)}: flagship ATE {ate_human:.6f} m, "
          f"polluted static ATE {ate_static:.6f} m (ratio "
          f"{ate_human / ate_static:.3f}); keyframes {len(slam.map.kfs)}, "
          f"trajectories {len(slam.map.trajectories)} ({n_opt} optimized), "
          f"human BA solves {slam.human_ba.n_runs}, reduced dimension D "
          f"{sorted(set(dims))}; launches {counts}")
    if not (ate_human < 0.6 * ate_static and ate_human < 0.03):
        _fail(f"human: flagship ATE {ate_human} m vs static {ate_static} m "
              f"(needs < 0.6x and < 0.03 m)")
    hba = [p["ms"] for p in per if p["human"]]
    kf_ms = [p["ms"] for i, p in enumerate(per)
             if p["kf"] and not p["human"] and i > 0]
    track_ms = [p["ms"] for p in per if not p["kf"] and not p["human"]]
    print(f"[human] per-frame ms tracking frames: {_ms_stats(track_ms)}; "
          f"keyframe frames after the first: {_ms_stats(kf_ms)}; human-BA "
          f"frames: {_ms_stats(hba)} on {smi}")
    print("[human] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']})"
        for k, v in sorted(spans.items())
        if k.startswith(("human_ba", "hba.", "map.static_ba", "track.step"))),
        flush=True)
    return counts


def _reloc_frames(frames, twc, blank: bool):
    """The static-28 frames 0..17, then N_BLANK all-zero frames (or frame
    17 again when blank is False) and N_HOLD repeats of frame 17: the
    camera pauses at its last pose through the blackout (no new
    rendering).  Returns the frames and their ground-truth centres."""
    last = frames[N_GOOD - 1]
    out = list(frames[:N_GOOD])
    for i in range(N_GOOD, N_GOOD + N_BLANK + N_HOLD):
        f = dataclasses.replace(last, index=i, timestamp=i * 0.1)
        if blank and i < N_GOOD + N_BLANK:
            f = dataclasses.replace(
                f, image_left=np.zeros_like(last.image_left),
                image_right=np.zeros_like(last.image_right))
        out.append(f)
    gt = np.concatenate([twc[:N_GOOD],
                         np.repeat(twc[N_GOOD - 1:N_GOOD], N_BLANK + N_HOLD,
                                   axis=0)])
    return out, gt


def phase_reloc(smi: str, frames, twc):
    """Relocalization at the bench budget: the blackout of
    tests/test_relocalization.py on the static-28 frames."""
    from airdos_tpu_torch.io.tum import ate_rmse
    from airdos_tpu_torch.slam.system import System

    cut, gt = _reloc_frames(frames, twc, blank=True)
    slam = System(_bench_config(), device="cuda")
    per = []
    _reset_counts()
    for data in cut:
        c0 = _counts()
        t0 = time.perf_counter()
        slam.track_stereo(data)
        _sync()
        dt = time.perf_counter() - t0
        c1 = _counts()
        per.append(dict(state=slam.tracking.state.name,
                        branch=slam.tracking.last_branch, ms=dt * 1e3,
                        ref=slam.tracking.last_frame.ref_kf_id,
                        d={k: c1[k] - c0[k] for k in c1}))
    counts = _counts()
    trk = slam.tracking
    for i, p in enumerate(per):
        print(f"[reloc] frame {i:2d} {p['state']:4s} {p['branch']:5s} "
              f"{p['ms']:9.2f} ms launches {p['d']}")
    if any(p["state"] != "OK" for p in per[:N_GOOD]):
        _fail(f"reloc: frames before the blackout not OK: "
              f"{[p['state'] for p in per[:N_GOOD]]}")
    if any(p["state"] != "LOST" for p in per[N_GOOD:N_GOOD + N_BLANK]):
        _fail("reloc: tracking not LOST during the blackout")
    if per[-1]["state"] != "OK" or trk.last_reloc_frame < N_GOOD + N_BLANK:
        _fail(f"reloc: state {per[-1]['state']} at the end, relocalized at "
              f"frame {trk.last_reloc_frame}")
    _, _, t_cut = trk.trajectory_tum()
    steps = np.linalg.norm(np.diff(t_cut, axis=0), axis=1)
    if not steps.max() < 0.12:
        _fail(f"reloc: a TUM step of {steps.max()} m")
    reloc_i = int(trk.last_reloc_frame)
    if per[reloc_i]["branch"] != "reloc" or \
            per[reloc_i]["d"]["match_rows"] <= 0 or \
            per[reloc_i]["d"]["match_resolve"] <= 0:
        _fail(f"reloc: frame {reloc_i} relocalized without a match_rows "
              f"launch with the resolve (the BoW match)")
    d = per[reloc_i]["d"]
    if d["epnp_hypotheses"] <= 0 or d["epnp_refine"] != \
            d["epnp_hypotheses"] or d["voc_transform"] <= 0:
        _fail(f"reloc: frame {reloc_i} relocalized without the EPnP "
              f"RANSAC's two launches a candidate and a voc_transform: {d}")
    ate_cut = float(ate_rmse(t_cut, gt[:len(t_cut)]))
    _FOR_MESH["reloc_frame"] = reloc_i
    full_frames, _ = _reloc_frames(frames, twc, blank=False)
    full = System(_bench_config(), device="cuda")
    _run(full, full_frames)
    _, _, t_full = full.tracking.trajectory_tum()
    ate_full = float(ate_rmse(t_full, gt[:len(t_full)]))
    if not ate_cut < max(2.0 * ate_full, 0.05):
        _fail(f"reloc: ATE {ate_cut} m vs the uninterrupted {ate_full} m")
    print(f"[reloc] relocalized at frame {reloc_i} against keyframe "
          f"{per[reloc_i]['ref']}: {trk.reloc_tried} candidates tried, "
          f"EPnP RANSAC inliers {trk.reloc_inliers}, frame latency "
          f"{per[reloc_i]['ms']:.2f} ms (145.21 ms with the eager RANSAC), "
          f"{d['epnp_hypotheses']} epnp_hypotheses, {d['epnp_refine']} "
          f"epnp_refine and {d['voc_transform']} voc_transform launches; "
          f"max TUM step {steps.max():.4f} m; "
          f"ATE {ate_cut:.6f} m (uninterrupted {ate_full:.6f} m); launches "
          f"{counts} on {smi}", flush=True)
    return counts


def _loop_config():
    """The pillar orbit at the bench budget: Camera.fps 5, loop closing."""
    cfg = _bench_config()
    cfg.camera.fps = 5.0
    cfg.enable_loop_closing = True
    return cfg


def _dump_map(m, sigma2) -> bytes:
    """KF / MP / Match lines of System.before_end for a map."""
    out = []
    for kf in sorted(m.kfs.values(), key=lambda k: k.id):
        if not kf.bad:
            out.append(f"{kf.id} " + " ".join(
                f"{v:.7f}" for v in np.concatenate([kf.Ow, kf.Rcw.ravel()])))
    pt = m.points
    for pid in pt.live_ids():
        p = pt.pos[pid]
        out.append(f"{pid} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f}")
        for kf_id, fid in pt.obs[pid].items():
            kf = m.kfs.get(kf_id)
            if kf is not None and not kf.bad:
                u, v = kf.xy_un[fid]
                out.append(f"{pid} {kf_id} {u:.3f} {v:.3f} "
                           f"{kf.u_right[fid]:.3f} "
                           f"{1.0 / sigma2[kf.octave[fid]]:.5f}")
    return "\n".join(out).encode()


def phase_loop(smi: str, frames, twc):
    """The pillar orbit through the offline System with loop closing at
    the bench budget.  Returns the launch counts and, for the loop it
    closed first, a deep copy of the loop closer (map, database, fuser and
    global BA with it) as compute_sim3 found it, with the keyframe and
    candidate."""
    from airdos_tpu_torch.slam import loop_closing
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.solvers.global_ba import launches_per_step

    slam = System(_loop_config(), device="cuda")
    snaps = []
    real_sim3 = loop_closing.LoopCloser.compute_sim3
    real_correct = loop_closing.LoopCloser.correct
    real_ransac = loop_closing.sim3_ransac
    last_ransac = []

    def sim3_ransac(*args, **kwargs):
        last_ransac[:] = [(args, kwargs)]
        return real_ransac(*args, **kwargs)

    def compute_sim3(self, kf, cand_id):
        # the generator's state before this call's RANSAC draws
        self._rng_before = copy.deepcopy(self.rng.bit_generator.state)
        return real_sim3(self, kf, cand_id)

    def correct(self, kf, res):
        # compute_sim3 reads the map and only the correction writes it:
        # a copy here, with the generator put back, replays both
        if not snaps:
            _FOR_MESH["sim3"] = last_ransac[0]
            t0 = time.perf_counter()
            snap = copy.deepcopy(self)
            snap.rng.bit_generator.state = self._rng_before
            snaps.append((snap, kf.id, res[4], time.perf_counter() - t0))
        return real_correct(self, kf, res)

    per = []
    loop_closing.LoopCloser.compute_sim3 = compute_sim3
    loop_closing.LoopCloser.correct = correct
    loop_closing.sim3_ransac = sim3_ransac
    fusion_watch, sim3_watch = _fusion_watch(), _sim3_watch()
    fusions, sim3s = fusion_watch.__enter__(), sim3_watch.__enter__()
    try:
        _reset_counts()
        for data in frames:
            c0, s0 = _counts(), slam.static_ba.n_solves
            g0 = slam.global_ba.n_runs
            lc = slam.loop_closer
            n0 = lc.n_loops_closed if lc is not None else 0
            n_snap = len(snaps)
            t0 = time.perf_counter()
            slam.track_stereo(data)
            _sync()
            # less the snapshot's deep copy, which is not the port's work
            dt = time.perf_counter() - t0 - sum(
                sn[3] for sn in snaps[n_snap:])
            c1 = _counts()
            lc = slam.loop_closer
            kf = slam.map.kfs.get(slam.tracking.last_kf_id)
            per.append(dict(state=slam.tracking.state.name,
                            branch=slam.tracking.last_branch, ms=dt * 1e3,
                            kf=kf is not None and kf.frame_id == data.index,
                            static=slam.static_ba.n_solves - s0,
                            gba=slam.global_ba.n_runs - g0,
                            loops=(lc.n_loops_closed if lc else 0) - n0,
                            d={k: c1[k] - c0[k] for k in c1}))
        counts = _counts()
    finally:
        sim3_watch.__exit__(None, None, None)
        fusion_watch.__exit__(None, None, None)
        loop_closing.LoopCloser.compute_sim3 = real_sim3
        loop_closing.LoopCloser.correct = real_correct
        loop_closing.sim3_ransac = real_ransac
    for i, p in enumerate(per):
        print(f"[loop] frame {i:2d} {p['state']} {p['branch']:5s} "
              f"{'KF' if p['kf'] else '  '} {'LOOP' if p['loops'] else '    '}"
              f" {p['ms']:9.2f} ms BA solves {p['static']} launches {p['d']}")
    bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
    if bad:
        _fail(f"loop: frames not OK: {bad}")
    lc = slam.loop_closer
    if lc is None or lc.n_loops_closed < 1 or not snaps:
        _fail("loop: no loop closed")
    if not any(k.loop_edges for k in slam.map.kfs.values()):
        _fail("loop: no loop edge")
    ate = _ate(slam.tracking, twc)
    if not ate < 0.15:
        _fail(f"loop: ATE {ate} m >= 0.15 m")
    # a closure: the essential graph (20 steps: a segment sum, a
    # Gauss-Newton and a cost sim3_edges each, and a first cost) and the
    # global BA (20 steps)
    per_loop = {k: 20 * n for k, n in launches_per_step(48).items()}
    per_loop["segment_sum"] += 20
    per_loop["sim3_edges"] = 1 + 2 * 20
    seg_off = [i for i, p in enumerate(per) if p["d"]["segment_sum"]
               != 45 * p["static"] + per_loop["segment_sum"] * p["loops"]]
    if seg_off:
        _fail(f"loop: segment_sum launches != 45 per static BA solve + "
              f"{per_loop['segment_sum']} per loop closure at frames "
              f"{seg_off}")
    solver_off = [(i, k, p["d"][k]) for i, p in enumerate(per)
                  for k in ("schur_point", "schur_camera", "sim3_edges")
                  if p["d"][k] != per_loop[k] * p["loops"]]
    if solver_off:
        _fail(f"loop: (frame, kernel, launches) {solver_off} not {per_loop} "
              f"per loop closure")
    if slam.global_ba.n_runs != lc.n_loops_closed:
        _fail("loop: not one global BA per loop closure")
    loop_frames = [i for i, p in enumerate(per) if p["loops"]]
    geo = [(i, {k: per[i]["d"][k] for k in ("horn_hypotheses",
                                            "horn_refine", "sim3_opt")})
           for i in loop_frames]
    if any(min(c.values()) <= 0 or c["horn_hypotheses"] != c["horn_refine"]
           for _, c in geo):
        _fail(f"loop: a loop frame without the Sim3 RANSAC's two launches "
              f"and a sim3_opt: {geo}")
    if any(per[i]["d"]["match_epipolar"] <= 0 or
           per[i]["d"]["triangulate"] <= 0 or
           per[i]["d"]["match_rows"] <= 0 or per[i]["d"]["match_fuse"] <= 0
           for i in loop_frames):
        _fail("loop: a loop frame launched no epipolar match_rows and "
              "triangulate (triangulation), match_rows (the BoW and Sim3 "
              "matches) or match_rows in fuse mode (SearchAndFuse)")
    sim3_off = [(i, c) for i, c in enumerate(sim3s) if c != (2, 0)]
    if not sim3s or sim3_off:
        _fail(f"loop: Sim3 match calls (call, (match_rows, Hamming "
              f"launches)) {sim3_off} not (2, 0), of {len(sim3s)}")
    fusion_off = _fusion_off(fusions)
    if fusion_off:
        _fail(f"loop: fusion calls (call, (fuse-mode match_rows, batched "
              f"Hamming launches)) {fusion_off} not (1, 0)")
    print(f"[loop] the Sim3 match: {len(sim3s)} calls, each two match_rows "
          f"launches and no Hamming kernel", flush=True)
    spans = slam.profiler.report()
    track_ms = [p["ms"] for p in per if not p["kf"]]
    kf_ms = [p["ms"] for i, p in enumerate(per)
             if p["kf"] and not p["loops"] and i > 0]
    print(f"[loop] pillar orbit {len(frames)} frames: loops closed "
          f"{lc.closed} (keyframe, candidate, matches, loop points); "
          f"keyframes {slam.map.n_keyframes()} live; map points "
          f"{slam.map.n_points()}; ATE {ate:.6f} m; loop frames "
          f"{loop_frames} at {[round(per[i]['ms'], 2) for i in loop_frames]}"
          f" ms; launches {counts}")
    print(f"[loop] per-frame ms tracking frames: {_ms_stats(track_ms)}; "
          f"keyframe frames without a loop: {_ms_stats(kf_ms)} on {smi}")
    print("[loop] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']}, max "
        f"{max(slam.profiler.stages[k]) * 1e3:.2f})"
        for k, v in sorted(spans.items())
        if k.startswith(("map.loop_closing", "loop.", "sim3.", "gba.",
                         "map.static_ba", "track.step"))), flush=True)
    med = {k: v["median_s"] * 1e3 for k, v in spans.items()}
    print(f"[loop] beside the eager versions' (median ms, PERF.md): "
          f"sim3.ransac {med.get('sim3.ransac', float('nan')):.2f} (9.93), "
          f"sim3.optimize {med.get('sim3.optimize', float('nan')):.2f} "
          f"(79.22 / 116.70), loop.detect "
          f"{med.get('loop.detect', float('nan')):.2f} (8.69); the loop "
          f"frames' launches of the new kernels {geo} on {smi}",
          flush=True)
    return counts, snaps[0][:3], slam.frontend.extractor, \
        dict(track_ms=track_ms, all_ms=[p["ms"] for p in per],
             loop_ms=[per[i]["ms"] for i in loop_frames],
             n_kfs=slam.map.next_kf_id)


def _frame_events(slam):
    """The online System's per-frame host times (s) and stamps from its
    event log, and the stamps of its loop closures."""
    frames = slam.events.events("frame")
    loops = slam.events.events("loop_closed")
    return (np.asarray([f["track_s"] for f in frames]),
            np.asarray([f["t"] for f in frames]),
            [ev["t"] for ev in loops])


class _TimedLock:
    """The online System's map lock with each hold recorded as (thread,
    site of the `with`, requested, acquired, released) on time.time(),
    the event log's clock."""

    def __init__(self, lock):
        self._lock = lock
        self._held = None
        self.holds = []

    def acquire(self, blocking=True, timeout=-1):
        t0 = time.time()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            f = sys._getframe(1)
            if f.f_code.co_name == "__enter__":
                f = f.f_back
            self._held = (threading.current_thread().name,
                          f"{Path(f.f_code.co_filename).name}:"
                          f"{f.f_code.co_name}:{f.f_lineno}", t0, time.time())
        return ok

    def release(self):
        held = self._held + (time.time(),)
        self._lock.release()
        self.holds.append(held)

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


def _time_map_lock(slam) -> _TimedLock:
    """Put a _TimedLock in place of the map lock everywhere the System
    keeps it (the loop closer, made later, takes System._map_lock)."""
    lock = _TimedLock(slam._map_lock)
    slam._map_lock = slam.tracking.map_lock = lock
    for holder in (slam.static_ba, slam.local_mapper.triangulator,
                   slam.local_mapper.fuser, slam.human_ba, slam.loop_closer):
        if holder is not None:
            holder.map_lock = lock
    return lock


def _lock_waits(lock: _TimedLock, t_end: float, seconds: float) -> str:
    """What the tracking thread waited for on the map lock in the frame
    that ended at t_end after `seconds`: its waits, and the other threads'
    holds that overlapped them, longest first."""
    t0 = t_end - seconds
    mine = [h for h in lock.holds if h[0] == "MainThread"
            and t0 <= h[2] <= t_end]
    waits = [(h[2], h[3]) for h in mine]
    waited = sum(b - a for a, b in waits)
    blockers = sorted(
        ((h[4] - h[3], h[0], h[1]) for h in lock.holds
         if h[0] != "MainThread"
         and any(h[3] < b and h[4] > a for a, b in waits)), reverse=True)
    held = ", ".join(f"{th} {site} {d * 1e3:.2f} ms"
                     for d, th, site in blockers[:4]) or "none"
    return (f"the tracking thread waited {waited * 1e3:.2f} ms in "
            f"{len(mine)} map-lock sections; held meanwhile by {held}")


def _stall_window(times, stamps, loop_stamps, skip: int = 20):
    """tests/test_loop_stall.py's window: which tracking frames are stamped
    in [t_loop - 8 s, t_loop + 2 s] of a loop closure, the first `skip`
    frames left out."""
    sel = np.zeros(len(times), bool)
    for t in loop_stamps:
        sel |= (stamps > t - 8.0) & (stamps < t + 2.0)
    sel[:skip] = False
    return sel


def _tally():
    out = {}
    for module in _MODULES:
        out.update(module().launch_tally())
    return out


def phase_online(smi: str, orbit, orbit_twc, crowd, crowd_twc, frames, twc,
                 offline_loop):
    """Online mode (is_offline=False): the pillar orbit with loop closing
    and the crowd flagship, then the rest of System's API on the static
    frames.  The pillar orbit runs twice: fed back to back, as every test
    and driver feeds an online System, and live, as a camera at the
    configuration's Camera.fps delivers it.  Returns the launch counts."""
    _reset_counts()
    _online_pillar(smi, orbit, orbit_twc, offline_loop, live=False)
    _online_pillar(smi, orbit, orbit_twc, offline_loop, live=True)
    _online_human(smi, crowd, crowd_twc)
    _online_api(frames, twc)
    return _counts()


def _feed(frames, fps):
    """The frames back to back (fps None), or as a live camera at `fps`
    delivers them: frame i not before i / fps s after the first, as the
    reference's drivers sleep to each frame's timestamp
    (stereo_human.cc:135-146)."""
    t0 = time.perf_counter()
    for i, data in enumerate(frames):
        wait = 0.0 if fps is None else t0 + i / fps - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        yield data


class _GcPauses:
    """Every collection of Python's cyclic garbage collector while the
    block runs, as (thread, generation, start, end) on time.time(), the
    event log's clock.  A collection holds the interpreter lock, so every
    other thread's Python waits for its end."""

    def __init__(self):
        self.pauses, self._t0 = [], None

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.time()
        elif self._t0 is not None:
            self.pauses.append((threading.current_thread().name,
                                info["generation"], self._t0, time.time()))
            self._t0 = None

    def __enter__(self):
        import gc
        self.tracked = len(gc.get_objects())
        self.frozen = gc.get_freeze_count()
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._callback)
        return False

    def within(self, t_end: float, seconds: float) -> str:
        """The collections that overlapped the frame that ended at t_end
        after `seconds`."""
        t0 = t_end - seconds
        hits = [(min(b, t_end) - max(a, t0), th, g)
                for th, g, a, b in self.pauses if a < t_end and b > t0]
        return ", ".join(f"{th} generation {g} {d * 1e3:.2f} ms"
                         for d, th, g in sorted(hits, reverse=True)) or "none"

    def summary(self) -> str:
        out = []
        for g in (0, 1, 2):
            d = [b - a for _, gen, a, b in self.pauses if gen == g]
            if d:
                out.append(f"generation {g}: {len(d)}, {sum(d) * 1e3:.2f} "
                           f"ms in all, longest {max(d) * 1e3:.2f} ms")
        return (f"{self.tracked} objects tracked and {self.frozen} frozen "
                f"at the start; "
                + ("; ".join(out) or "no collection"))


def _run_online_pillar(orbit, fps):
    """The pillar orbit through the online System at the bench budget,
    fed by _feed(orbit, fps), frame i + 1 prefetched before frame i.
    Returns the System (shut down), each frame's state, and
    tests/test_loop_stall.py's numbers: the tracking thread's per-frame
    host times (s), their median after frame 20, the stall window's mask,
    its worst frame (or None), what the tracking thread waited for on the
    map lock in that frame, and the bound max(3 x median, median + 0.5 s);
    and per frame the mapping load: the keyframes it inserted, whether the
    busy branch of Tracking._need_new_keyframe refused one (mapping busy
    and >= 3 keyframes queued), and the queue's length at the frame's
    end."""
    from airdos_tpu_torch.slam.system import System
    cfg = _loop_config()
    cfg.system.is_offline = False
    slam = System(cfg, device="cuda")
    lock = _time_map_lock(slam)
    trk = slam.tracking
    queue_len, refused = trk.mapping_queue_len_fn, [0]

    def read_queue():        # read only when a keyframe is due while busy
        n = queue_len()
        refused[0] += n >= 3
        return n
    trk.mapping_queue_len_fn = read_queue
    states, load = [], []
    with _GcPauses() as gc_pauses:
        for i, data in enumerate(_feed(orbit, fps)):
            if i + 1 < len(orbit):
                slam.prefetch(orbit[i + 1])
            k0, r0 = slam.map.next_kf_id, refused[0]
            slam.track_stereo(data)
            states.append(trk.state.name)
            load.append((slam.map.next_kf_id - k0, refused[0] - r0,
                         queue_len()))
        slam.shutdown()
    times, stamps, loop_stamps = _frame_events(slam)
    med = float(np.median(times[20:]))
    sel = _stall_window(times, stamps, loop_stamps)
    worst, waits, gc_worst = None, "none", "none"
    if sel.any():
        i = np.flatnonzero(sel)[np.argmax(times[sel])]
        worst, waits = float(times[i]), _lock_waits(lock, stamps[i], times[i])
        gc_worst = gc_pauses.within(stamps[i], times[i])
    return slam, states, dict(times=times, med=med, sel=sel, worst=worst,
                              waits=waits, bound=max(3.0 * med, med + 0.5),
                              load=np.asarray(load), gc=gc_pauses.summary(),
                              gc_worst=gc_worst, gc_log=gc_pauses)


def _mapping_load(st) -> str:
    """The mapping load of a _run_online_pillar run, over the run and in
    its stall window."""
    inserted, refused, queued = st["load"].T
    sel = st["sel"]
    return (f"keyframes inserted {int(inserted.sum())}, refused "
            f"{int(refused.sum())}, longest queue {int(queued.max())}; in "
            f"the stall window inserted {int(inserted[sel].sum())}, refused "
            f"{int(refused[sel].sum())}, longest queue "
            f"{int(queued[sel].max()) if sel.any() else 0}")


def _online_pillar(smi, orbit, orbit_twc, offline_loop, live: bool):
    """a. pillar-84 online, fed back to back or live at Camera.fps: the
    checks and the prints."""
    from airdos_tpu_torch.utils.gate import TRACKING_PRIORITY

    fps = _loop_config().camera.fps if live else None
    feed = "back to back" if fps is None else f"live at {fps:g} fps"
    slam, states, st = _run_online_pillar(orbit, fps)
    counts, tally = _counts(), _tally()     # counted from 0 at the phase
    lc = slam.loop_closer
    times, sel, worst, med = st["times"], st["sel"], st["worst"], st["med"]
    ms = times * 1e3
    print(f"[online] pillar-{len(orbit)} {feed}: states {collections.Counter(states)}"
          f", keyframes {len(slam.map.kfs)} inserted "
          f"({slam.map.n_keyframes()} live), loops closed "
          f"{lc.closed if lc else None}, global BA runs "
          f"{slam.global_ba.n_runs} (aborted {slam.global_ba.n_aborted}); "
          f"launches {counts}")
    if not st["gc_log"].frozen:
        _fail(f"online {feed}: the System froze no object against the "
              f"garbage collector's scans")
    if states[-1] != "OK":
        _fail(f"online {feed}: the last pillar frame is {states[-1]}")
    if lc is None or lc.n_loops_closed < 1:
        _fail(f"online {feed}: no loop closed")
    if slam.global_ba.n_runs < 1:
        _fail(f"online {feed}: the global BA never ran in its background "
              f"thread")
    ate = _ate(slam.tracking, orbit_twc)
    if not ate < 0.15:
        _fail(f"online {feed}: pillar ATE {ate} m >= 0.15 m")
    warm = times[20:]
    stalled = times[sel]
    off = offline_loop
    print(f"[online] pillar ATE {ate:.6f} m; tracking-frame ms online (all "
          f"{len(ms)} frames, the tracking thread's host time): "
          f"{_ms_stats(ms)}, after frame 20 {_ms_stats(warm * 1e3)}; offline "
          f"in phase loop: tracking frames {_ms_stats(off['track_ms'])}, all "
          f"frames {_ms_stats(off['all_ms'])}, loop frames "
          f"{[round(x, 2) for x in off['loop_ms']]} ms; loop stall window "
          f"{len(stalled)} frames, worst "
          f"{'none' if worst is None else f'{worst * 1e3:.2f}'} ms against "
          f"the bound max(3 x {med * 1e3:.2f}, {med * 1e3:.2f} + 500) ms on "
          f"{smi}", flush=True)
    print(f"[online] stall window frames (ms): "
          f"{[round(float(x) * 1e3, 1) for x in stalled]}; in the worst "
          f"{st['waits']}; garbage collections in the worst: "
          f"{st['gc_worst']}", flush=True)
    print(f"[online] garbage collections over the run: {st['gc']}",
          flush=True)
    print(f"[online] mapping load online: {_mapping_load(st)}; offline in "
          f"phase loop: keyframes inserted {off['n_kfs']}", flush=True)
    if worst is not None and not worst < st["bound"]:
        _fail(f"online {feed}: a loop closure stalled tracking: {worst} s "
              f"against a median of {med} s")
    spans = slam.profiler.report()
    print("[online] worker spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']}, max "
        f"{max(slam.profiler.stages[k]) * 1e3:.2f})"
        for k, v in sorted(spans.items())
        if k.startswith(("map.", "loop.", "gba.", "ba.", "track"))),
        flush=True)
    print("[online] launches by (kernel, thread, stream priority): "
          + ", ".join(f"{k} {v}" for k, v in sorted(tally.items())),
          flush=True)
    track_prio = {p for (name, th, p) in tally if th == "MainThread"
                  and name == "match_rows"}
    worker = {(name, p) for (name, th, p) in tally if th == "mapping"
              and name in ("match_epipolar", "triangulate", "match_fuse",
                           "segment_sum")}
    if not track_prio or {n for n, _ in worker} != \
            {"match_epipolar", "triangulate", "match_fuse", "segment_sum"}:
        _fail(f"online: launches missing from the tally {tally}")
    if track_prio != {min(track_prio)} or min(track_prio) > \
            TRACKING_PRIORITY:
        _fail(f"online: tracking's match_rows launches on priorities "
              f"{track_prio}")
    if any(p <= max(track_prio) for _, p in worker):
        _fail(f"online: the mapping worker's launches {worker} are not on "
              f"a stream of lower priority than tracking's {track_prio}")
    # the loop correction's solvers: the essential graph in the mapping
    # worker, the global BA in its background thread
    solvers = {(name, th, p) for (name, th, p) in tally
               if name in ("schur_point", "schur_camera", "sim3_edges")}
    want = {("sim3_edges", "mapping"), ("schur_point", "global-ba"),
            ("schur_camera", "global-ba")}
    if {(n, th) for n, th, _ in solvers} != want or \
            any(p <= max(track_prio) for _, _, p in solvers):
        _fail(f"online: the loop solvers' launches by (kernel, thread, "
              f"priority) {sorted(solvers)}, not {sorted(want)} on a stream "
              f"of lower priority than tracking's {track_prio}")


def _online_human(smi, crowd, crowd_twc):
    """b. crowd-27 online human (tests/test_online_human.py)."""
    from airdos_tpu_torch.slam.system import System

    cfg = _human_bench_config()
    cfg.system.is_offline = False
    slam = System(cfg, device="cuda")
    launched = []
    real_launch = slam.human_ba.launch

    def launch(kf_id):
        ok = real_launch(kf_id)
        launched.append(ok)
        return ok
    slam.human_ba.launch = launch
    for data in crowd:
        slam.track_stereo_human(data)
    slam.shutdown()          # raises what the background human BA raised
    n_opt = sum(t.optimized for t in slam.map.trajectories.values())
    ate_h = _ate(slam.tracking, crowd_twc)
    times, _, _ = _frame_events(slam)
    print(f"[online] crowd-{len(crowd)} flagship: state "
          f"{slam.tracking.state.name}, human BA launches {launched.count(True)}"
          f" (ticks skipped while one ran {launched.count(False)}), solves "
          f"{slam.human_ba.n_runs}, trajectories optimized {n_opt}, ATE "
          f"{ate_h:.6f} m; tracking-frame ms {_ms_stats(times * 1e3)} on "
          f"{smi}", flush=True)
    if slam.tracking.state.name != "OK":
        _fail("online human: the last frame is not OK")
    if slam.human_ba.n_runs < 2 or launched.count(True) < 2:
        _fail(f"online human: {slam.human_ba.n_runs} human BA solves")
    if n_opt < 1:
        _fail("online human: no trajectory optimized")
    if not ate_h < 0.03:
        _fail(f"online human: ATE {ate_h} m >= 0.03 m")


def _online_api(frames, twc):
    """c. localization-only mode, reset and prefetch on static-28."""
    import torch
    from airdos_tpu_torch.slam.frame import FrontEnd
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.utils.gate import TRACKING_PRIORITY

    cfg = _bench_config()
    cfg.system.is_offline = False
    slam = System(cfg, device="cuda")
    for data in frames[:18]:
        slam.track_stereo(data)
    if not slam.drain_mapping(120.0):
        _fail("api: the mapping worker did not drain")
    slam.global_ba.join()
    n_kfs, n_pts = len(slam.map.kfs), slam.map.n_points()
    slam.activate_localization_mode()
    loc = []
    for data in frames[18:]:
        frame = slam.track_stereo(data)
        loc.append(slam.tracking.state.name)
    err = float(np.linalg.norm(frame.Ow - twc[len(frames) - 1]))
    print(f"[online] localization-only frames 18-{len(frames) - 1}: states "
          f"{collections.Counter(loc)}, keyframes {n_kfs} -> "
          f"{len(slam.map.kfs)}, points {n_pts} -> {slam.map.n_points()}, "
          f"last pose error {err:.4f} m", flush=True)
    if set(loc) != {"OK"} or len(slam.map.kfs) != n_kfs or \
            slam.map.n_points() != n_pts or not err < 0.5:
        _fail("api: localization-only mode changed the map or lost track")
    slam.deactivate_localization_mode()
    slam.shutdown()

    slam = System(cfg, device="cuda")
    for data in frames[:6]:
        slam.track_stereo(data)
    resets = []
    for start, with_gba in ((6, False), (12, True)):
        if with_gba:
            slam.global_ba.launch(slam._map_lock)
        running = slam.global_ba._thread is not None and \
            slam.global_ba._thread.is_alive()
        slam.reset()
        if slam.map.n_keyframes() != 0 or slam.tracking.records or \
                slam.tracking.state.name != "NOT_INITIALIZED":
            _fail("api: reset left a map or a state behind")
        for data in frames[start:start + 6]:
            slam.track_stereo(data)
        resets.append((start, running, slam.tracking.state.name,
                       slam.map.n_keyframes()))
        if slam.tracking.state.name != "OK" or slam.map.n_keyframes() < 1:
            _fail(f"api: no re-initialization after the reset at {start}")
    slam.shutdown()
    if not resets[1][1]:
        _fail("api: the global BA was not running at the second reset")
    print(f"[online] resets (frame, global BA running, state, keyframes "
          f"after 6 frames): {resets}; global BA aborted "
          f"{slam.global_ba.n_aborted}", flush=True)

    fe = FrontEnd(cfg, device="cuda")
    side = torch.cuda.Stream(priority=TRACKING_PRIORITY)
    with torch.cuda.stream(side):
        plain = fe.build_frame(frames[5])
        fe.prefetch(frames[5])
        pre = fe.build_frame(frames[5])
    same = all(np.array_equal(getattr(plain, k), getattr(pre, k))
               for k in ("xy", "desc32", "octave", "valid", "u_right"))
    print(f"[online] prefetched frame 5 on a second stream: keypoints, "
          f"descriptors, octaves and stereo bit-equal to the plain upload: "
          f"{same} ({int(plain.valid.sum())} features)", flush=True)
    if not same:
        _fail("api: a prefetched frame differs from the plain upload")


def _replay(snap, device, extractor):
    """compute_sim3 -> correct of the snapshot's loop on a deep copy of
    it, on `device` (the CPU gets its own vocabulary tables, fuser and
    global BA over the copied map)."""
    from airdos_tpu_torch.convert import (loop_closer_state_from,
                                          vocabulary_from)
    from airdos_tpu_torch.slam.ba_driver import Fuser, GlobalBA
    from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
    from airdos_tpu_torch.slam.loop_closing import LoopCloser
    src, kf_id, cand = snap
    lc = copy.deepcopy(src)
    if device == "cpu":
        m, cfg = lc.map, lc.config
        db = KeyFrameDatabase(vocabulary_from(lc.db.voc, device="cpu"), m)
        db.inverted = lc.db.inverted
        cpu = LoopCloser(cfg, m, db, extractor, "cpu",
                         fuser=Fuser(cfg, m, extractor, device="cpu"),
                         global_ba=GlobalBA(cfg, m, extractor, device="cpu"))
        loop_closer_state_from(lc, cpu)
        lc = cpu
    kf = lc.map.kfs[kf_id]
    res = lc.compute_sim3(kf, cand)
    if res is None or not lc.correct(kf, res):
        _fail(f"loop replay on {device}: the loop {kf_id} -> {cand} did not "
              f"close again")
    return lc.map


def phase_loop_replay(snap, extractor):
    """Loop determinism and agreement: compute_sim3 -> correct (essential
    graph and global BA included) of the first closed loop, replayed on
    two deep copies of the closer taken when it ran, on the card (the KF /
    MP / Match dumps byte-identical) and on the CPU (keyframes within the
    tolerance of tests/test_torch_loop_system.py: 2e-3 in R, 5e-3 m in
    t)."""
    sigma2 = extractor.sigma2
    t0 = time.perf_counter()
    a, b = (_replay(snap, "cuda", extractor) for _ in range(2))
    card_s = (time.perf_counter() - t0) / 2
    da, db_ = _dump_map(a, sigma2), _dump_map(b, sigma2)
    if da != db_:
        _fail("loop determinism: two card replays of the loop differ")
    t0 = time.perf_counter()
    c = _replay(snap, "cpu", extractor)
    cpu_s = time.perf_counter() - t0
    dR = max(float(np.abs(a.kfs[k].Rcw - c.kfs[k].Rcw).max())
             for k in a.kfs if not a.kfs[k].bad)
    dt = max(float(np.abs(a.kfs[k].tcw - c.kfs[k].tcw).max())
             for k in a.kfs if not a.kfs[k].bad)
    print(f"[loop-replay] keyframe {snap[1]} -> candidate {snap[2]}: two card "
          f"replays byte-identical ({len(da)} bytes of KF/MP/Match, "
          f"{card_s:.2f} s each); CPU vs card keyframes max |dR| {dR:.2e}, "
          f"max |dt| {dt:.2e} m (CPU replay {cpu_s:.2f} s)", flush=True)
    if dR > 2e-3 or dt > 5e-3:
        _fail(f"loop agreement: CPU vs card keyframes |dR| {dR}, |dt| {dt}")


def _corridor(rng, C: int, P: int, per_cam: int):
    """tests/test_global_ba.py's drifting corridor: C cameras along z
    (0.25 m apart), P points, up to per_cam stereo observations a camera
    (0.2 px noise), points off by 0.05 m, and the test's camera drift at
    its last (200th) keyframe reached at the C-th: (0.2, 0.1, 0.15) m and
    0.1 rad of yaw (the test's 0.0005 rad a keyframe would reach 0.5 rad
    at 1000 keyframes, beyond what 20 Gauss-Newton steps start from).
    Returns the solver's arrays (first camera fixed), the cameras' true
    centres and the drifted ones."""
    fx = fy = 300.0
    cx, cy, bf = 160.0, 120.0, 60.0
    ctr_gt = np.stack([0.01 * np.arange(C), np.zeros(C), 0.25 * np.arange(C)],
                      axis=1).astype(np.float32)
    pts_gt = np.stack([rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
                       rng.uniform(2, 0.25 * C + 10, P)],
                      axis=1).astype(np.float32)
    cams, pids, obs = [], [], []
    order = np.argsort(pts_gt[:, 2])
    zs = pts_gt[order, 2]
    for c in range(C):
        lo, hi = np.searchsorted(zs, [ctr_gt[c, 2] + 1.0,
                                      ctr_gt[c, 2] + 25.0])
        sel = order[lo:hi]
        xc = pts_gt[sel] - ctr_gt[c]
        u = fx * xc[:, 0] / xc[:, 2] + cx
        v = fy * xc[:, 1] / xc[:, 2] + cy
        ok = (u > 0) & (u < 320) & (v > 0) & (v < 240)
        sel, u, v, z = sel[ok], u[ok], v[ok], xc[ok, 2]
        keep = rng.permutation(len(sel))[:per_cam]
        n = len(keep)
        cams.append(np.full(n, c, np.int32))
        pids.append(sel[keep].astype(np.int32))
        obs.append(np.stack([u[keep], v[keep], u[keep] - bf / z[keep]], 1)
                   + rng.normal(0, 0.2, (n, 3)))
    e_cam, e_pt = np.concatenate(cams), np.concatenate(pids)
    e_obs = np.concatenate(obs).astype(np.float32)
    ctr_n = ctr_gt + np.linspace(0, 1, C)[:, None] * \
        np.array([0.2, 0.1, 0.15], np.float32)
    yaw = 0.1 * np.arange(C) / max(C, 200)
    R_n = np.zeros((C, 3, 3), np.float32)
    R_n[:, 0, 0] = R_n[:, 2, 2] = np.cos(yaw)
    R_n[:, 0, 2], R_n[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    R_n[:, 1, 1] = 1.0
    t_n = -np.einsum("cij,cj->ci", R_n, ctr_n).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    E = len(e_cam)
    arrays = (R_n, t_n, fixed,
              (pts_gt + rng.normal(0, 0.05, pts_gt.shape)).astype(np.float32),
              np.ones(P, bool), e_cam, e_pt, e_obs,
              np.ones(E, np.float32), np.ones(E, bool))
    return arrays, (fx, fy, cx, cy, bf), ctr_gt, ctr_n


def _chi2_sum(dev, cam, R, t, pts) -> float:
    """The reprojection chi2 of every edge of a global BA problem (device
    arrays as solve_global_ba takes them) at (R, t, pts)."""
    from airdos_tpu_torch.solvers.local_ba import _proj_residual
    e_cam, e_pt = dev[5].long(), dev[6].long()
    e, _, _, _ = _proj_residual(R[e_cam], t[e_cam], pts[e_pt], dev[7], *cam,
                                dev[7][:, 2] >= 0)
    return float(((e * e).sum(-1) * dev[8]).sum())


def _timed_device(fn, reps: int = 2):
    """Runs fn reps times, each ended by a synchronize; the host seconds
    of each run and the results."""
    out, secs = [], []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        out.append(fn())
        _sync()
        secs.append(time.perf_counter() - t0)
    return secs, out


def _busy_ms(fn):
    """Device busy time (ms) of one call of fn and its kernel count, from
    torch.profiler's CUDA trace (device activity only: a solve launches
    ~50,000 kernels, and host events would triple what the trace holds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3, len(evs)


def phase_map_scale(smi: str):
    """The loop solvers at the map scale airdos_tpu's GlobalBA is built for
    (solvers/global_ba.py: hundreds of keyframes, 10^5 points): the global
    BA in GlobalBA's schedule over tests/test_global_ba.py's corridor at
    C = 1000 keyframes, P = 100,000 points, ~300 observations a keyframe,
    and the essential graph over the same 1000 keyframes with one loop
    edge (D = 7000).  Each runs twice on the card, bit-equal."""
    import torch
    from airdos_tpu_torch.convert import to_device
    from airdos_tpu_torch.slam.ba_driver import solve_global_ba
    from airdos_tpu_torch.solvers.global_ba import launches_per_step
    from airdos_tpu_torch.solvers.pose_graph import optimize_essential_graph

    C, P = 1000, 100_000
    t0 = time.perf_counter()
    arrays, cam, ctr_gt, ctr_n = _corridor(np.random.default_rng(SEED), C, P,
                                           300)
    E = len(arrays[5])
    print(f"[map-scale] corridor C {C}, P {P}, E {E} edges made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = [to_device(a, "cuda") for a in arrays]
    _reset_counts()
    secs, outs = _timed_device(lambda: solve_global_ba(*dev, *cam))
    launches = _counts()
    want = {k: 2 * 20 * n for k, n in launches_per_step(48).items()}
    got = {k: launches[k] for k in want}
    if got != want:
        _fail(f"map scale: launches in two global BAs {got}, not {want}")
    (R1, t1, p1), (R2, t2, p2) = outs
    if not (torch.equal(R1, R2) and torch.equal(t1, t2)
            and torch.equal(p1, p2)):
        _fail("map scale: two card runs of the global BA differ")
    R, t = R1.cpu().numpy(), t1.cpu().numpy()
    moved = np.linalg.norm(t[1:] - arrays[1][1:], axis=1)
    chi0 = _chi2_sum(dev, cam, dev[0], dev[1], dev[3])
    chi1 = _chi2_sum(dev, cam, R1, t1, p1)
    ctr = -np.einsum("cij,ci->cj", R, t)
    e0 = np.linalg.norm(ctr_n - ctr_gt, axis=1)
    e1 = np.linalg.norm(ctr - ctr_gt, axis=1)
    if not ((moved > 1e-5).all() and chi1 < 1e-2 * chi0):
        _fail(f"map scale: free keyframes moved {(moved > 1e-5).mean():.3f}, "
              f"reprojection chi2 {chi0} -> {chi1}")
    _FOR_MESH["map_scale"] = (arrays, cam, R, t)
    busy, n_k = _busy_ms(lambda: solve_global_ba(*dev, *cam))
    print(f"[map-scale] global BA (4 calls x 5 steps, 48 CG iterations): "
          f"{[round(s, 3) for s in secs]} s per solve, two runs bit-equal, "
          f"each {launches['segment_sum'] // 2} segment_sum launches "
          f"(camera-keyed {C} x 42 | 42, point-keyed {P} x 12 | 3 over "
          f"{E} rows), {launches['schur_point'] // 2} schur_point and "
          f"{launches['schur_camera'] // 2} schur_camera; device busy "
          f"{busy:.2f} ms in {n_k} kernels (torch.profiler, a third "
          f"solve); every free keyframe moved; reprojection chi2 "
          f"{chi0:.6g} -> {chi1:.6g}; mean centre error to "
          f"the truth {e0.mean():.4f} -> {e1.mean():.4f} m over all "
          f"keyframes, {e0[:200].mean():.4f} -> {e1[:200].mean():.4f} m over "
          f"the first 200 on {smi}", flush=True)

    # the essential graph: the drifted chain as odometry edges, one loop
    # edge from the true relative pose of the last and first keyframes
    Rg = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    tg = -ctr_gt
    Rn, tn = arrays[0], arrays[1]
    ei = np.concatenate([np.arange(C - 1), [C - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, C), [0]]).astype(np.int32)
    Rs = np.concatenate([Rn[1:] @ Rn[:-1].transpose(0, 2, 1),
                         (Rg[0] @ Rg[C - 1].T)[None]])
    ts = np.concatenate([tn[1:] - np.einsum("eij,ej->ei", Rs[:-1], tn[:-1]),
                         (tg[0] - Rs[-1] @ tg[C - 1])[None]])
    fixed = np.zeros(C, bool)
    fixed[0] = True
    args = [to_device(a, "cuda", np.float32 if a.dtype.kind == "f" else None)
            for a in (Rn, tn, np.ones(C, np.float32), fixed, ei, ej, Rs, ts,
                      np.ones(C, np.float32), np.ones(C, bool))]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    real_grad = torch.autograd.grad
    grads = []
    torch.autograd.grad = lambda *a, **k: grads.append(1) or \
        real_grad(*a, **k)
    try:
        secs, outs = _timed_device(lambda: optimize_essential_graph(*args))
    finally:
        torch.autograd.grad = real_grad
    eg = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: launches[k] + eg[k] for k in launches}
    want = {"segment_sum": 2 * 20, "sim3_edges": 2 * (1 + 2 * 20)}
    got = {k: eg[k] for k in want}
    if got != want or grads:
        _fail(f"map scale: launches in two essential graphs {got}, not "
              f"{want}; {len(grads)} autograd passes")
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        _fail("map scale: two card runs of the essential graph differ")
    t_out = outs[0][1].cpu().numpy()
    moved = np.linalg.norm(t_out[1:] - tn[1:], axis=1)
    err0 = float(np.linalg.norm(tn[-1] - tg[-1]))
    err1 = float(np.linalg.norm(t_out[-1] - tg[-1]))
    if not ((moved > 1e-6).all() and err1 < 0.5 * err0):
        _fail(f"map scale: essential graph moved "
              f"{(moved > 1e-6).mean():.3f} of the free keyframes, loop end "
              f"error {err0} -> {err1} m")
    busy, n_k = _busy_ms(lambda: optimize_essential_graph(*args))
    print(f"[map-scale] essential graph K {C} (D {7 * C}), E {C} edges, 20 "
          f"LM steps: {[round(s, 3) for s in secs]} s per solve, two runs "
          f"bit-equal, each 20 segment_sum launches (one compact segment "
          f"sum of the 14x14 + 14 entries of every edge a step) and 41 "
          f"sim3_edges (a Gauss-Newton and a cost launch a step, a first "
          f"cost), no autograd pass; peak "
          f"device memory {peak:.2f} GiB; device busy {busy:.2f} ms in "
          f"{n_k} kernels; loop end error {err0:.4f} -> {err1:.4f} m on "
          f"{smi}", flush=True)
    return launches


def phase_determinism():
    """Two card runs of the mapping System: byte-identical outputs."""
    from airdos_tpu_torch.slam.system import System
    frames = _small_frames(8)
    OUT_DIR.mkdir(exist_ok=True)
    outs = []
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        for tag in ("a", "b"):
            slam = System(_small_config(), device="cuda")
            _run(slam, frames)
            traj = Path(tmp) / f"traj_{tag}.txt"
            dump = Path(tmp) / f"dump_{tag}"
            slam.save_trajectory_tum(traj)
            slam.before_end(dump)
            outs.append([traj.read_bytes()] + [
                (dump / f).read_bytes()
                for f in ("KF.txt", "MP.txt", "Match.txt")])
            if slam.static_ba.n_solves < 1:
                _fail("determinism: the run made no BA solve")
    if outs[0] != outs[1]:
        diff = [f for f, a, b in zip(("traj", "KF", "MP", "Match"), *outs)
                if a != b]
        _fail(f"determinism: two card runs differ in {diff}")
    print(f"[determinism] small camera, 8 frames, two card runs: TUM and "
          f"KF/MP/Match byte-identical ({sum(map(len, outs[0]))} bytes)",
          flush=True)

    names = ("KF.txt", "MP.txt", "Match.txt", "HMTraj.txt", "Motion.txt")
    frames = _small_human_frames(10)
    outs = []
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        for tag in ("a", "b"):
            slam = System(_small_human_config(), device="cuda")
            _run(slam, frames)
            traj = Path(tmp) / f"traj_{tag}.txt"
            dump = Path(tmp) / f"dump_{tag}"
            slam.save_trajectory_tum(traj)
            slam.before_end(dump)
            outs.append([traj.read_bytes()] + [(dump / f).read_bytes()
                                               for f in names])
            if slam.human_ba.n_runs < 2:
                _fail(f"determinism: the human run made "
                      f"{slam.human_ba.n_runs} human BA solves, not >= 2")
    if outs[0] != outs[1]:
        diff = [f for f, a, b in zip(("traj",) + names, *outs) if a != b]
        _fail(f"determinism: two human card runs differ in {diff}")
    print(f"[determinism] human System, small camera, 10 frames, "
          f"{slam.human_ba.n_runs} human BA solves, two card runs: TUM and "
          f"KF/MP/Match/HMTraj/Motion byte-identical "
          f"({sum(map(len, outs[0]))} bytes)", flush=True)


def phase_cpu_agreement():
    """The same small-camera frames through the mapping System on the CPU
    (plain versions) and on the card: the same branches and keyframes,
    poses within 5 mm / 1e-3."""
    from airdos_tpu_torch.slam.system import System
    frames = _small_frames(6)
    cpu = System(_small_config(), device="cpu")
    gpu = System(_small_config(), device="cuda")
    per_cpu = _run(cpu, frames)
    per_gpu = _run(gpu, frames)
    if [p[:2] for p in per_cpu] != [p[:2] for p in per_gpu]:
        _fail(f"CPU and GPU branches differ: {per_cpu} vs {per_gpu}")
    _, R_c, t_c = cpu.tracking.trajectory_tum()
    _, R_g, t_g = gpu.tracking.trajectory_tum()
    dt = float(np.abs(t_c - t_g).max())
    dR = float(np.abs(R_c - R_g).max())
    if cpu.map.n_keyframes() != gpu.map.n_keyframes() or dt > 5e-3 \
            or dR > 1e-3:
        _fail(f"CPU vs GPU: keyframes {cpu.map.n_keyframes()} vs "
              f"{gpu.map.n_keyframes()}, max |dt| {dt}, max |dR| {dR}")
    print(f"[agree] mapping System, small camera, 6 frames: CPU and GPU "
          f"branches equal, keyframes {gpu.map.n_keyframes()}, BA solves "
          f"{gpu.static_ba.n_solves}, max |dt| {dt:.2e} m, max |dR| "
          f"{dR:.2e}", flush=True)

    frames = _small_human_frames(10)
    runs = []
    for device in ("cpu", "cuda"):
        slam = System(_small_human_config(), device=device)
        first = {}
        write_back = slam.human_ba._write_back

        def snapshot(problem, res, write_back=write_back, first=first):
            write_back(problem, res)
            if not first:        # the joints after the first solve
                first.update({t.track_id: np.stack(
                    [hp.joints_w[:14] for hp in t.poses])
                    for t in problem["trajs"]})
                first["observed"] = {t.track_id: np.stack(
                    [hp.in_keyframe & ~hp.bad[:14] for hp in t.poses])
                    for t in problem["trajs"]}
        slam.human_ba._write_back = snapshot
        runs.append((slam, _run(slam, frames), first))
    (cpu, per_cpu, f_cpu), (gpu, per_gpu, f_gpu) = runs
    if [p[:2] for p in per_cpu] != [p[:2] for p in per_gpu]:
        _fail(f"human: CPU and GPU branches differ: {per_cpu} vs {per_gpu}")
    shape = {k: len(t) for k, t in cpu.map.trajectories.items()}
    if shape != {k: len(t) for k, t in gpu.map.trajectories.items()}:
        _fail("human: CPU and GPU trajectories differ")
    _, _, t_c = cpu.tracking.trajectory_tum()
    _, _, t_g = gpu.tracking.trajectory_tum()
    dt = float(np.abs(t_c - t_g).max())
    obs_gap, other_gap = [0.0], [0.0]
    for tid, observed in f_cpu.pop("observed").items():
        g = np.linalg.norm(f_cpu[tid] - f_gpu[tid], axis=-1)
        obs_gap.append(float(g[observed].max(initial=0.0)))
        other_gap.append(float(g[~observed].max(initial=0.0)))
    end = np.concatenate([np.linalg.norm(
        a.joints_w[:14] - b.joints_w[:14], axis=-1).ravel()
        for tid in cpu.map.trajectories for a, b in zip(
            cpu.map.trajectories[tid].poses, gpu.map.trajectories[tid].poses)])
    print(f"[agree] human System, small camera, 10 frames, "
          f"{gpu.human_ba.n_runs} human BA solves: CPU and GPU branches and "
          f"trajectories equal, cameras max |dt| {dt:.2e} m; after the "
          f"first solve joints with an inlier projection edge max gap "
          f"{max(obs_gap):.2e} m, other joints {max(other_gap):.2e} m; end "
          f"of run joint gap median {np.median(end):.2e} m, max "
          f"{end.max():.2e} m", flush=True)
    if dt > 1e-4 or max(obs_gap) > 5e-3:
        _fail(f"human: CPU vs GPU cameras {dt} m or observed joints "
              f"{max(obs_gap)} m beyond 1e-4 / 5e-3 m")


def phase_profile(smi: str):
    """Where the time goes at the bench size, mapping System over the 28
    bench frames: stage timers with a synchronize on both sides (tracking
    stages per fused frame from frame 6 on; triangulation, fusion and the
    BA solve per keyframe), then torch.profiler over each of the last four
    frames (device kernels, device busy time and share, by branch and
    keyframe).  The profiler's tables of the last frame go to
    chiprun_out/profile_slice.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import airdos_tpu_torch.matching.epipolar as epipolar
    import airdos_tpu_torch.slam.ba_driver as ba_driver
    import airdos_tpu_torch.slam.frame as frame_mod
    import airdos_tpu_torch.slam.fused as fused
    from airdos_tpu_torch.slam.system import System

    frames, twc = _bench_frames(N_FRAMES)
    slam = System(_bench_config(), device="cuda")
    acc = collections.defaultdict(float)

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return wrapped

    track_stages = [
        (slam.frontend, "_build_impl", "front end (both images, stereo)"),
        (frame_mod, "stereo_match", "  of which stereo match"),
        (fused, "match_last_frame", "motion-model match"),
        (fused, "match_local_points", "local-map match"),
        (fused, "pose_optimize", "pose LM")]
    lm = slam.local_mapper
    tri = lm.triangulator
    # triangulation's parts: the host's assembly under the map lock, the
    # prelude's eager ops (triangulate_pair less its two launches), the
    # two launches, the copy back (the rest) and the write-back
    map_stages = [(lm, "triangulator", "triangulation"),
                  (tri, "_assemble", "  of which _assemble"),
                  (ba_driver, "triangulate_pair",
                   "  of which triangulate_pair"),
                  (epipolar, "match_rows", "    of which epipolar match_rows"),
                  (epipolar, "triangulate_rows", "    of which triangulate"),
                  (tri, "_write_back", "  of which the write-back"),
                  (lm, "fuser", "fusion"),
                  (ba_driver, "local_bundle_adjust", "BA solve")]
    for obj, attr, name in track_stages + map_stages:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    fast_rows, kf_rows = [], []
    for i, d in enumerate(frames[:-4]):
        before = dict(acc)
        t0 = time.perf_counter()
        slam.track_stereo(d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {k: acc[k] - before.get(k, 0.0) for k in acc}
        row["frame total"] = wall
        kf = slam.map.kfs.get(slam.tracking.last_kf_id)
        if kf is not None and kf.frame_id == d.index and i > 0:
            kf_rows.append(row)
        elif i >= 6 and slam.tracking.last_branch == "fast":
            fast_rows.append(row)
    for rows, label, names in (
            (fast_rows, "fused frames without a keyframe, from frame 6",
             [n for _, _, n in track_stages]),
            (kf_rows, "keyframe frames after the first",
             [n for _, _, n in map_stages])):
        print(f"[profile] {label}: {len(rows)}; synchronized stage timers, "
              f"median ms per frame on {smi}:")
        for name in names + ["frame total"]:
            v = [r.get(name, 0.0) * 1e3 for r in rows]
            print(f"[profile]   {name:32s} ms "
                  f"{np.median(v) if v else float('nan'):9.2f}")
    stages = slam.profiler.report()
    print("[profile] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']})"
        for k, v in sorted(stages.items())))

    # the last four frames, each under its own torch.profiler: a frame's
    # device busy time against its wall time, by branch and keyframe
    for d in frames[-4:]:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            slam.track_stereo(d)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in evs) / 1e3

        def kernel_ms(tag):
            t = [e.time_range.elapsed_us() for e in evs if tag in e.name]
            return len(t), (f"{sum(t) / len(t) / 1e3:.4f} ms" if t
                            else "not measured")

        mine = "; ".join(
            "{} {} launches, mean device time {}".format(tag, *kernel_ms(tag))
            for tag in ("hamming_kernel", "match_rows_kernel",
                        "triangulate_kernel", "segment_sum_",
                        "pose_lm_kernel",
                        "pyramid_levels_kernel", "fast_nms_levels_kernel",
                        "select_kernel", "orb_desc_levels_kernel",
                        "stereo_sad_kernel", "patch_disparity_kernel",
                        "static_rows_kernel", "static_cost_kernel",
                        "static_cost_sum_kernel", "landmark_reduce_kernel",
                        "landmark_backsub_kernel"))
        kf = slam.map.kfs.get(slam.tracking.last_kf_id)
        is_kf = kf is not None and kf.frame_id == d.index
        print(f"[profile] frame {d.index} ({slam.tracking.last_branch}"
              f"{', keyframe' if is_kf else ''}) under torch.profiler: "
              f"{len(evs)} device kernels (3,020 a fused frame with the "
              f"pyramid, blur, selection and SAD as eager torch: PERF.md), "
              f"device busy {busy_ms:.2f} ms, "
              f"wall {wall_ms:.2f} ms (the profiler slows the host), busy "
              f"share {busy_ms / wall_ms:.4f}; {mine}; on {smi}")
    OUT_DIR.mkdir(exist_ok=True)
    out = OUT_DIR / "profile_slice.txt"
    ka = prof.key_averages()
    out.write_text(ka.table(sort_by="self_cuda_time_total", row_limit=40)
                   + "\n" + ka.table(sort_by="count", row_limit=25))
    print(f"[profile] tables in {out}", flush=True)

    # relocalization's and ComputeSim3's stages
    orbit, _ = _orbit_frames(N_ORBIT)
    geometry_split(smi, frames, twc, orbit, counts=_counts)

    # the flagship's human BA stages: assembly and write-back on the host,
    # the solve ending in its one copy back (a device sync)
    crowd, _ = _crowd_frames(N_CROWD)
    slam = System(_human_bench_config(), device="cuda")
    _run(slam, crowd)
    stages = slam.profiler.report()
    print(f"[profile] crowd-{N_CROWD} flagship, {slam.human_ba.n_runs} human "
          f"BA solves; spans (median / max ms): " + ", ".join(
              f"{k} {v['median_s'] * 1e3:.2f} / "
              f"{max(slam.profiler.stages[k]) * 1e3:.2f}"
              for k, v in sorted(stages.items())
              if k.startswith(("human_ba", "hba."))) + f" on {smi}",
          flush=True)

    # one more solve of the last window under torch.profiler: the solve's
    # device busy time against its wall time, and the kernels that hold it
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slam.human_ba(slam.map, slam.tracking.last_kf_id)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel = collections.defaultdict(float)
    for e in evs:
        per_kernel[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] one human BA solve under torch.profiler: wall "
          f"{wall_ms:.2f} ms (the profiler slows the host), {len(evs)} "
          f"device kernels, device busy {busy_ms:.2f} ms (share "
          f"{busy_ms / wall_ms:.4f}); most device time: " + "; ".join(
              f"{name[:60]} {ms:.2f} ms" for name, ms in top) +
          f" on {smi}", flush=True)


GEOMETRY_STAGES = (
    # (owner, attribute, stage), the owners by module path
    ("airdos_tpu_torch.bow.vocabulary:Vocabulary", "transform",
     "BoW transform"),
    ("airdos_tpu_torch.slam.keyframe_db:KeyFrameDatabase",
     "detect_reloc_candidates", "reloc candidates"),
    ("airdos_tpu_torch.slam.tracking", "match_by_bow", "SearchByBoW"),
    ("airdos_tpu_torch.slam.tracking", "epnp_ransac", "EPnP RANSAC"),
    ("airdos_tpu_torch.slam.tracking:Tracking", "_opt_pose_with_assoc",
     "pose optimization"),
    ("airdos_tpu_torch.slam.tracking:Tracking", "_reloc_expand",
     "projection expansion"),
    ("airdos_tpu_torch.slam.loop_closing:LoopCloser", "compute_sim3",
     "ComputeSim3"),
    ("airdos_tpu_torch.slam.loop_closing", "match_by_bow",
     "  of which SearchByBoW"),
    ("airdos_tpu_torch.slam.loop_closing", "sim3_ransac",
     "  of which Sim3 RANSAC"),
    ("airdos_tpu_torch.slam.loop_closing", "optimize_sim3",
     "  of which OptimizeSim3"))


def _owner(path: str):
    import importlib
    mod, _, cls = path.partition(":")
    obj = importlib.import_module(mod)
    return getattr(obj, cls) if cls else obj


def geometry_split(smi: str, frames, twc, orbit, counts=None,
                   busy: bool = True) -> dict:
    """Where relocalization's and ComputeSim3's time goes: phase reloc's
    blackout and the pillar orbit through Systems whose GEOMETRY_STAGES
    are each timed with a synchronize on both sides (and, with counts, its
    kernel launches counted).  Prints the relocalizing frame's stages and
    the ComputeSim3 calls' (medians), the spans sim3.* and loop.detect,
    and with busy the relocalizing frame's and each ComputeSim3's device
    busy time (torch.profiler, device activity only, in a second run of
    the blackout and inline in the orbit).  Returns them as a dict.  Also
    run by tools/reloc_loop_ab.py on an older checkout, hence the owners
    by name and counts optional."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from airdos_tpu_torch.slam.system import System
    counts = counts or (lambda: {})
    rec = []                       # (frame, stage, ms, launches, busy ms)
    at = {"frame": -1, "profile": None}

    def timed(stage, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            prof = None
            if at["profile"] == stage:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            dev = None
            if prof is not None:
                prof.__exit__(None, None, None)
                dev = sum(e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type ==
                          torch.autograd.DeviceType.CUDA) / 1e3
            c1 = counts()
            rec.append((at["frame"], stage, ms,
                        {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]},
                        dev))
            return out
        return wrapped

    saved = [(_owner(o), a, getattr(_owner(o), a))
             for o, a, _ in GEOMETRY_STAGES]
    for (obj, attr, fn), (_, _, stage) in zip(saved, GEOMETRY_STAGES):
        setattr(obj, attr, timed(stage, fn))
    out = {}
    try:
        cut, _ = _reloc_frames(frames, twc, blank=True)

        def blackout(profile_at=None):
            slam = System(_bench_config(), device="cuda")
            per = []
            for i, data in enumerate(cut):
                at["frame"] = i
                prof = None
                if i == profile_at:
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                torch.cuda.synchronize()
                c0, t0 = counts(), time.perf_counter()
                slam.track_stereo(data)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                c1 = counts()
                dev = None
                if prof is not None:
                    prof.__exit__(None, None, None)
                    evs = [e for e in prof.events() if e.device_type ==
                           torch.autograd.DeviceType.CUDA]
                    dev = (sum(e.time_range.elapsed_us() for e in evs)
                           / 1e3, len(evs))
                per.append((ms, {k: c1[k] - c0[k] for k in c1
                                 if c1[k] != c0[k]}, dev))
            return slam.tracking.last_reloc_frame, per

        ri, per = blackout()
        if not 0 <= ri < len(per):
            raise RuntimeError(f"the blackout did not relocalize ({ri})")
        ri = int(ri)
        stages = [(st, ms, d) for f, st, ms, d, _ in rec if f == ri]
        out["reloc"] = dict(frame=ri, ms=per[ri][0], launches=per[ri][1],
                            stages=collections.defaultdict(float))
        for st, ms, _ in stages:
            out["reloc"]["stages"][st] += ms
        print(f"[split] the relocalizing frame {ri} of phase reloc's "
              f"blackout: {per[ri][0]:.2f} ms, launches {per[ri][1]}; "
              f"synchronized stages (calls, ms, launches) on {smi}:")
        for st in dict.fromkeys(st for st, _, _ in stages):
            ms = [m for x, m, _ in stages if x == st]
            la = collections.Counter()
            for x, _, d in stages:
                if x == st:
                    la.update(d)
            print(f"[split]   {st:28s} {len(ms):3d} {sum(ms):9.2f} ms "
                  f"{dict(la)}")
        if busy:
            rec.clear()
            ri2, per2 = blackout(profile_at=ri)
            if ri2 == ri and per2[ri][2] is not None:
                busy_ms, n_k = per2[ri][2]
                out["reloc"]["busy_ms"] = busy_ms
                print(f"[split]   under torch.profiler (a second run): "
                      f"{n_k} device kernels, device busy {busy_ms:.2f} ms "
                      f"of {per2[ri][0]:.2f} ms")

        rec.clear()
        at["profile"] = "ComputeSim3" if busy else None
        slam = System(_loop_config(), device="cuda")
        for i, data in enumerate(orbit):
            at["frame"] = i
            slam.track_stereo(data)
        at["profile"] = None
        calls = [r for r in rec if r[1] == "ComputeSim3"]
        print(f"[split] pillar-{len(orbit)}: {len(calls)} ComputeSim3 calls "
              f"at frames {[r[0] for r in calls]}, loops closed "
              f"{slam.loop_closer.n_loops_closed}; synchronized stages "
              f"(calls, median ms, launches of the first) on {smi}:")
        out["sim3"] = {}
        for _, _, stage in GEOMETRY_STAGES[6:]:
            rows = [r for r in rec if r[1] == stage]
            if not rows:
                continue
            med = float(np.median([r[2] for r in rows]))
            out["sim3"][stage.strip()] = med
            dev = [r[4] for r in rows if r[4] is not None]
            extra = (f", device busy median {np.median(dev):.2f} ms "
                     f"(under torch.profiler)" if dev else "")
            print(f"[split]   {stage:28s} {len(rows):3d} {med:9.2f} ms "
                  f"{rows[0][3]}{extra}")
        spans = slam.profiler.report()
        out["spans"] = {k: v["median_s"] * 1e3 for k, v in spans.items()
                        if k.startswith(("sim3.", "loop."))}
        print("[split]   spans (median ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(out["spans"].items())),
            flush=True)
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return out


def _settings_yaml(cfg) -> str:
    """A reference-format settings YAML (the keys of the reference's
    Examples/Stereo/config/*.yaml and the port's Device.* budgets, as
    tests/test_examples_cli.py writes them) whose SlamConfig.from_yaml is
    cfg, field for field; fails if it is not."""
    from airdos_tpu_torch.config import SlamConfig
    c, o, h, p, s = cfg.camera, cfg.orb, cfg.human, cfg.optimizer, cfg.system
    d = cfg.device
    keys = {
        "Camera.fx": c.fx, "Camera.fy": c.fy, "Camera.cx": c.cx,
        "Camera.cy": c.cy, "Camera.k1": c.k1, "Camera.k2": c.k2,
        "Camera.p1": c.p1, "Camera.p2": c.p2, "Camera.k3": c.k3,
        "Camera.width": c.width, "Camera.height": c.height,
        "Camera.fps": c.fps, "Camera.bf": c.bf, "Camera.RGB": c.rgb,
        "ThDepth": cfg.th_depth,
        "ORBextractor.nFeatures": o.n_features,
        "ORBextractor.scaleFactor": o.scale_factor,
        "ORBextractor.nLevels": o.n_levels,
        "ORBextractor.iniThFAST": o.ini_th_fast,
        "ORBextractor.minThFAST": o.min_th_fast,
        "Human.OK": h.ok, "Human.isSeg": h.is_seg,
        "Human.UseTrackedId": h.use_tracked_id, "Human.RejectTh": h.reject_th,
        "Optimizer.SigmaStatic": p.sigma_static,
        "Optimizer.SigmaHuman": p.sigma_human,
        "Optimizer.SigmaMotion": p.sigma_motion,
        "Optimizer.SigmaRigidity": p.sigma_rigidity,
        "Optimizer.ThHuberMotion": p.th_huber_motion,
        "Optimizer.ThRanSacMotion": p.th_ransac_motion,
        "Optimizer.ThRanSacRigidity": p.th_ransac_rigidity,
        "Optimizer.IsHuber": p.is_huber,
        "Optimizer.IsKeyFrameOnly": p.is_keyframe_only,
        "Optimizer.IsAllKF": p.is_all_kf,
        "Optimizer.IsStaticOnly": p.is_static_only,
        "System.IsOffline": s.is_offline, "System.IsMask": s.is_mask,
        "System.IsGroundTruthDepth": s.is_ground_truth_depth,
        "Schedular.nStartImage": cfg.scheduler.n_start_image,
        "Schedular.nEndImage": cfg.scheduler.n_end_image,
        "Device.MaxKeypoints": d.max_keypoints,
        "Device.MaxLocalKFs": d.max_local_kfs,
        "Device.MaxFixedKFs": d.max_fixed_kfs,
        "Device.MaxLocalPoints": d.max_local_points,
        "Device.MaxBAEdges": d.max_ba_edges,
        "Device.MaxTrajectories": d.max_trajectories,
        "Device.MaxTrajectoryLen": d.max_trajectory_len,
        "Device.NChips": d.n_chips}
    text = "%YAML:1.0\n" + "".join(
        f"{k}: {repr(float(v)) if isinstance(v, float) else int(v)}\n"
        for k, v in keys.items())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "settings.yaml"
        path.write_text(text)
        back = SlamConfig.from_yaml(path)
    if dataclasses.asdict(back) != dataclasses.asdict(cfg):
        diff = {k: (v, dataclasses.asdict(cfg)[k])
                for k, v in dataclasses.asdict(back).items()
                if v != dataclasses.asdict(cfg)[k]}
        _fail(f"drivers: the settings YAML reads back otherwise: {diff}")
    return text


def _q8(img) -> np.ndarray:
    """A rendered float image as the uint8 a dataset's PNG holds."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _twin(d, timestamp=None):
    """What a sequence reader gives back for frame d written to disk: the
    images quantized to uint8 as float32, the detections as float64, the
    track ids as int64 (a frame without them: none)."""
    humans = {k: None if getattr(d, k) is None else
              np.asarray(getattr(d, k), np.float64).reshape(-1, 18, 3)
              for k in ("humans_left", "humans_right")}
    return dataclasses.replace(
        d, timestamp=d.timestamp if timestamp is None else timestamp,
        image_left=_q8(d.image_left).astype(np.float32),
        image_right=_q8(d.image_right).astype(np.float32),
        track_ids=None if d.track_ids is None
        else np.asarray(d.track_ids).astype(np.int64).reshape(-1),
        **humans)


def _write_rows(path: Path, rows) -> None:
    """A whitespace text matrix whose values read back bit-equal."""
    path.write_text("".join(" ".join(repr(v) for v in row) + "\n"
                            for row in np.asarray(rows).tolist()))


def _write_tartanair(root: Path, frames) -> None:
    """frames in the TartanAir-Shibuya layout (io/datasets.py): images,
    segmentation, AlphaPose detections, track ids, times.txt."""
    from airdos_tpu_torch.io.png import imwrite
    for sub in ("image_0", "image_1", "rcnnseg_image_0", "rcnnseg_image_1",
                "alphapose_0", "alphapose_1", "track_id_alpha"):
        (root / sub).mkdir(parents=True)
    for i, d in enumerate(frames):
        name = f"{i:06d}"
        imwrite(root / "image_0" / f"{name}.png", _q8(d.image_left))
        imwrite(root / "image_1" / f"{name}.png", _q8(d.image_right))
        if d.seg_left is not None:
            imwrite(root / "rcnnseg_image_0" / f"{name}.png", d.seg_left)
            imwrite(root / "rcnnseg_image_1" / f"{name}.png", d.seg_right)
        if d.humans_left is not None:
            _write_rows(root / "alphapose_0" / f"{name}.txt",
                        np.asarray(d.humans_left).reshape(-1, 54))
            _write_rows(root / "alphapose_1" / f"{name}.txt",
                        np.asarray(d.humans_right).reshape(-1, 54))
            _write_rows(root / "track_id_alpha" / f"{name}.txt",
                        np.asarray(d.track_ids).reshape(-1, 1))
    (root / "times.txt").write_text("".join(f"{float(d.timestamp)!r}\n"
                                            for d in frames))


def _same_frame(got, want) -> bool:
    """Every FrameData field equal, arrays with their dtypes."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            if not (isinstance(a, np.ndarray) and a.dtype == b.dtype
                    and a.shape == b.shape and np.array_equal(a, b)):
                return False
        elif a != b:
            return False
    return True


@contextlib.contextmanager
def _systems_made():
    """The System objects constructed inside the context (the drivers make
    theirs inside main), so their per-frame times can be read."""
    import airdos_tpu_torch.slam.system as system_mod
    made, cls = [], system_mod.System

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    system_mod.System = Recorded
    try:
        yield made
    finally:
        system_mod.System = cls


def _drive(main, args):
    """A driver's main(args) in this process, on the card (failing unless
    it returns 0): its standard output and the System it made."""
    out = io.StringIO()
    with _systems_made() as made, contextlib.redirect_stdout(out):
        rc = main(args)
    if rc != 0:
        _fail(f"drivers: {main.__module__} {args} exited {rc}: "
              f"{out.getvalue()}")
    if len(made) != 1:
        _fail(f"drivers: {main.__module__} made {len(made)} Systems")
    return out.getvalue(), made[0]


def _paeth_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 gray image with every row Paeth-filtered: the
    decoder's slowest rows, which libpng's writers choose for most rows of
    a natural image."""
    import struct
    import zlib
    x = img.astype(np.int64)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((x.shape[0], 1), 4),
                           (x - pred) % 256], axis=1).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


@contextlib.contextmanager
def _kitti_cli(frames):
    """Phase 14a's subprocess, started as soon as static-28 has rendered
    so that it overlaps the other scenes' rendering: the frames written in
    the KITTI layout (uint8 PNGs, times.txt) with a settings YAML that
    reads back as _bench_config(), and python -m
    airdos_tpu_torch.examples.stereo_kitti run on them.  Yields the paths
    and the process; on leaving, the process is stopped if it still runs
    and the files are removed."""
    from airdos_tpu_torch.io.png import imwrite
    OUT_DIR.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=OUT_DIR))
    proc = None
    try:
        yaml, kitti = root / "static.yaml", root / "kitti"
        yaml.write_text(_settings_yaml(_bench_config()))
        (kitti / "image_0").mkdir(parents=True)
        (kitti / "image_1").mkdir()
        for i, d in enumerate(frames):
            imwrite(kitti / "image_0" / f"{i:06d}.png", _q8(d.image_left))
            imwrite(kitti / "image_1" / f"{i:06d}.png", _q8(d.image_right))
        (kitti / "times.txt").write_text("".join(
            f"{float(d.timestamp)!r}\n" for d in frames))
        traj = root / "kitti_cli.txt"
        with open(root / "cli.log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "airdos_tpu_torch.examples.stereo_kitti", str(yaml),
                 str(kitti), str(traj)],
                cwd=Path(__file__).resolve().parent, stdout=log,
                stderr=subprocess.STDOUT)
        yield dict(root=root, yaml=yaml, kitti=kitti, traj=traj, proc=proc)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)


def phase_drivers(smi: str, frames, twc, crowd, crowd_twc, memory, cli):
    """The dataset drivers on the card (python -m
    airdos_tpu_torch.examples.*), each byte-identical to the in-memory
    System on the same uint8 inputs (memory: phases mapping's and
    human's trajectories; cli: _kitti_cli's); the evaluator and the
    viewer.  Returns the launch counts of the phase."""
    from airdos_tpu_torch.examples import (stereo_euroc, stereo_human,
                                           stereo_kitti)
    from airdos_tpu_torch.io.datasets import (KittiStereoSequence,
                                              TartanAirStereoSequence)
    from airdos_tpu_torch.io.png import imread_grayscale, imwrite
    from airdos_tpu_torch.io.rectify import (init_undistort_rectify_map,
                                             remap_linear)
    from airdos_tpu_torch.io.tum import ate_rmse, read_trajectory_tum
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.tools import evaluate
    from airdos_tpu_torch.viz.frame_drawer import save_frame_overlay

    OUT_DIR.mkdir(exist_ok=True)
    _reset_counts()
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp_name:
        tmp = Path(tmp_name)
        # a. KITTI layout: the CLI started before the other scenes
        # rendered (_kitti_cli), then main() in this process, against
        # phase mapping's System on the same uint8 frames
        yaml, kitti = cli["yaml"], cli["kitti"]
        twins = [_twin(d) for d in frames]
        t0 = time.perf_counter()
        read = list(KittiStereoSequence(kitti))
        read_ms = (time.perf_counter() - t0) * 1e3 / (2 * len(frames))
        bad = [i for i, (g, w) in enumerate(zip(read, twins))
               if not _same_frame(g, dataclasses.replace(
                   w, humans_left=None, humans_right=None, track_ids=None,
                   seg_left=None, seg_right=None))]
        if bad:
            _fail(f"drivers: KITTI frames {bad} read back otherwise")
        try:
            rc = cli["proc"].wait(timeout=900)
        except subprocess.TimeoutExpired:
            _fail("drivers: the stereo_kitti CLI ran past 900 s")
        if rc != 0:
            _fail(f"drivers: the stereo_kitti CLI exited {rc}: "
                  f"{(cli['root'] / 'cli.log').read_text()[-4000:]}")
        cli_lines = cli["traj"].read_text().splitlines()
        if len(cli_lines) != len(frames) or \
                any(len(r.split()) != 12 for r in cli_lines):
            _fail(f"drivers: the CLI wrote {len(cli_lines)} KITTI lines")
        c0 = _counts()
        out_a, drv_a = _drive(stereo_kitti.main, [
            str(yaml), str(kitti), str(tmp / "kitti_main.txt")])
        c1 = _counts()
        launches_a = {k: c1[k] - c0[k] for k in c1}
        for tag, path in (("main", tmp / "kitti_main.txt"),
                          ("cli", cli["traj"])):
            if path.read_bytes() != memory["kitti"]:
                _fail(f"drivers: the KITTI driver's trajectory ({tag}) "
                      f"differs from the in-memory System's")
        ms_a = [t * 1e3 for t in drv_a.track_times]
        print(f"[drivers] a. KITTI layout, static-{len(frames)}: the "
              f"stereo_kitti CLI exited 0 with {len(cli_lines)} KITTI lines; "
              f"main() and the CLI byte-identical to phase mapping's "
              f"in-memory System ({len(memory['kitti'])} bytes); driver "
              f"tracking ms {_ms_stats(ms_a)}; reader {read_ms:.2f} ms per "
              f"image; launches {launches_a}; {out_a.strip()} on {smi}",
              flush=True)

        # b. TartanAir layout, the flagship on crowd-27
        human_yaml = tmp / "human.yaml"
        human_yaml.write_text(_settings_yaml(_human_bench_config()))
        tartan = tmp / "tartanair"
        _write_tartanair(tartan, crowd)
        twins = [_twin(d) for d in crowd]
        bad = [i for i, (g, w) in enumerate(zip(
            TartanAirStereoSequence(tartan), twins)) if not _same_frame(g, w)]
        if bad:
            _fail(f"drivers: TartanAir frames {bad} read back otherwise")
        c0 = _counts()
        dump = tmp / "dump"
        out_b, drv_b = _drive(stereo_human.main, [
            str(human_yaml), str(tartan), str(tmp / "human_main.txt"),
            str(dump)])
        c1 = _counts()
        launches_b = {k: c1[k] - c0[k] for k in c1}
        if (tmp / "human_main.txt").read_bytes() != memory["tartanair"]:
            _fail("drivers: the stereo_human driver's TUM differs from phase "
                  "human's in-memory flagship")
        missing = [f for f in ("KF.txt", "MP.txt", "Match.txt", "HMTraj.txt",
                               "Motion.txt") if not (dump / f).is_file()]
        if missing:
            _fail(f"drivers: SaveMap files not written: {missing}")
        ts_b, _, t_b = read_trajectory_tum(tmp / "human_main.txt")
        ate_b = float(ate_rmse(t_b, crowd_twc[:len(t_b)]))
        if not ate_b < 0.03:
            _fail(f"drivers: stereo_human ATE {ate_b} m >= 0.03 m")
        ms_b = [t * 1e3 for t in drv_b.track_times]
        print(f"[drivers] b. TartanAir layout, crowd-{len(crowd)} flagship: the "
              f"stereo_human driver's TUM byte-identical to phase human's "
              f"in-memory flagship; SaveMap files written; ATE {ate_b:.6f} m; "
              f"{drv_b.human_ba.n_runs} human BA solves; driver tracking ms "
              f"{_ms_stats(ms_b)}; launches {launches_b} on {smi}",
              flush=True)

        # c. EuRoC layout, identity rectification, static-28 frames 0-13;
        # then one frame rectified with a plumb-bob distortion
        cam = _bench_config().camera
        K = [cam.fx, 0.0, cam.cx, 0.0, cam.fy, cam.cy, 0.0, 0.0, 1.0]
        blocks = {"K": (3, 3, K), "D": (1, 5, [0.0] * 5),
                  "R": (3, 3, [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]),
                  "P": (3, 4, K[:3] + [0.0] + K[3:6] + [0.0] + K[6:] + [0.0])}
        euroc_yaml = tmp / "euroc.yaml"
        euroc_yaml.write_text(
            _settings_yaml(_bench_config())
            + f"LEFT.width: {cam.width}\nLEFT.height: {cam.height}\n"
            + "".join(f"{side}.{key}: !!opencv-matrix\n   rows: {r}\n"
                      f"   cols: {c}\n   dt: d\n   data: ["
                      + ", ".join(repr(float(v)) for v in data) + "]\n"
                      for side in ("LEFT", "RIGHT")
                      for key, (r, c, data) in blocks.items()))
        n_euroc = min(14, len(frames))
        names = [1_403_636_579_000_000_000 + int(round(d.timestamp * 1e9))
                 for d in frames[:n_euroc]]
        for cam_dir, key in (("cam0", "image_left"), ("cam1", "image_right")):
            data_dir = tmp / "euroc" / "mav0" / cam_dir / "data"
            data_dir.mkdir(parents=True)
            for ns, d in zip(names, frames):
                imwrite(data_dir / f"{ns}.png", _q8(getattr(d, key)))
        (tmp / "euroc_ts.txt").write_text("".join(f"{ns}\n" for ns in names))
        c0 = _counts()
        _, drv_c = _drive(stereo_euroc.main, [
            str(euroc_yaml), str(tmp / "euroc"), str(tmp / "euroc_ts.txt"),
            str(tmp / "euroc_main.txt")])
        c1 = _counts()
        launches_c = {k: c1[k] - c0[k] for k in c1}
        mem = System(_bench_config(), device="cuda")
        _run(mem, [_twin(d, ns / 1e9) for ns, d in zip(names, frames)])
        mem.save_trajectory_tum(tmp / "euroc_memory.txt")
        if (tmp / "euroc_main.txt").read_bytes() != \
                (tmp / "euroc_memory.txt").read_bytes():
            _fail("drivers: the stereo_euroc driver's TUM (identity "
                  "rectification) differs from the in-memory System's")
        # the reference EuRoC.yaml's cam0 distortion and rectifying
        # rotation on this camera
        raw = _q8(frames[0].image_left)
        Kc = np.asarray(K).reshape(3, 3)
        D = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
        R = [[0.999966347530033, -0.001422739138722922, 0.008079580483432283],
             [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
             [-0.008089410156878961, -0.007044357138835809,
              0.9999424675829176]]
        t0 = time.perf_counter()
        mx, my = init_undistort_rectify_map(Kc, D, R, Kc,
                                            (cam.width, cam.height))
        maps_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rect = remap_linear(raw, mx, my)
        remap_ms = (time.perf_counter() - t0) * 1e3
        if rect.shape != raw.shape or rect.dtype != np.uint8 \
                or np.array_equal(rect, raw) or not rect.any():
            _fail("drivers: the plumb-bob rectification gave no image")
        # decode time per 640x360 image: this writer's Sub rows and an
        # all-Paeth file (libpng's writers filter most rows of a natural
        # image with Paeth or Average)
        paeth = tmp / "paeth.png"
        paeth.write_bytes(_paeth_png(raw))
        dec = {}
        for tag, path in (("sub", kitti / "image_0" / "000000.png"),
                          ("paeth", paeth)):
            t0 = time.perf_counter()
            for _ in range(3):
                img = imread_grayscale(path)
            dec[tag] = (time.perf_counter() - t0) * 1e3 / 3
            if not np.array_equal(img, raw):
                _fail(f"drivers: the {tag}-filtered PNG reads back otherwise")
        print(f"[drivers] c. EuRoC layout, static-{len(frames)} frames 0-{n_euroc - 1}, "
              f"identity rectification: the stereo_euroc driver's TUM "
              f"byte-identical to the in-memory System's; driver tracking "
              f"ms {_ms_stats([t * 1e3 for t in drv_c.track_times])}; "
              f"launches {launches_c}; plumb-bob rectification of one "
              f"{cam.width}x{cam.height} frame: maps {maps_ms:.2f} ms, remap "
              f"{remap_ms:.2f} ms; PNG decode per {cam.width}x{cam.height} "
              f"image (host): Sub rows {dec['sub']:.2f} ms, Paeth rows "
              f"{dec['paeth']:.2f} ms on {smi}", flush=True)

        # d. the evaluator on b's TUM against the ground truth as TUM
        gt = tmp / "gt.txt"
        gt.write_text("".join(
            " ".join(repr(float(v)) for v in (t, *p)) + " 0 0 0 1\n"
            for t, p in zip(ts_b, np.asarray(crowd_twc))))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            evaluate.main(["--estimate", str(tmp / "human_main.txt"),
                           "--gt", str(gt)])
        lines = dict(line.split(":", 1) for line in
                     text.getvalue().splitlines() if ":" in line)
        ate_eval = float(lines["ATE RMSE [m]"])
        ate_sys = _ate(drv_b.tracking, crowd_twc)
        if not abs(ate_eval - ate_sys) <= 1e-6:
            _fail(f"drivers: evaluate's ATE {ate_eval} vs {ate_sys}")
        print(f"[drivers] d. evaluate on b's TUM: "
              + "; ".join(l.strip() for l in text.getvalue().splitlines())
              + f"; chip_smoke's ATE {ate_sys:.7f} m", flush=True)

    # e. the viewer on the card
    slam = System(_bench_config(), device="cuda", use_viewer=True)
    slam.viewer.keep_overlays = True
    last = None
    for d in frames[:6]:
        last = slam.track_stereo(d)
    slam.shutdown()
    v = slam.viewer
    overlay = OUT_DIR / "drivers_overlay.ppm"
    img = save_frame_overlay(str(overlay), last, slam.tracking.state.name,
                             slam.map.n_keyframes(), slam.map.n_points(),
                             image=frames[5].image_left)
    if len(v.poses) != 6 or len(v.frame_overlays) != 6 \
            or overlay.stat().st_size != 15 + img.size:
        _fail(f"drivers: the viewer recorded {len(v.poses)} poses, "
              f"{len(v.frame_overlays)} overlays")
    print(f"[drivers] e. viewer: System(use_viewer=True) recorded "
          f"{len(v.poses)} poses and overlays; overlay written to {overlay} "
          f"({overlay.stat().st_size} bytes)", flush=True)
    return _counts()


def _long_horizon_config(mask: bool, human_ba: bool):
    """tests/test_long_horizon_dynamic.py's _cfg: the small camera, the
    human BA every 5 frames over 8 x 8 poses."""
    cfg = _small_config()
    cfg.camera.fps = 5.0
    cfg.human.ok = human_ba or mask
    cfg.human.is_seg = mask
    cfg.system.is_mask = mask
    cfg.optimizer.is_static_only = not human_ba
    cfg.device.max_trajectories = 8
    cfg.device.max_trajectory_len = 8
    return cfg


def _long_horizon_frames():
    """tests/test_long_horizon_dynamic.py's 110-frame crowd: the camera
    drives through 10 drifting humans; the world (its humans are the
    ground truth), the frames and the camera centres."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(seed=2, n_points=500, n_humans=10,
                                 cam=_small_config().camera, crowd=True)
    Rwc, twc = world.trajectory(N_LONG, 0.1, speed=0.35, yaw_rate=0.003)
    frames = _render(world, Rwc, twc, 0.1, True)
    print(f"[frames] rendered {N_LONG} long-horizon crowd frames 320x240 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return world, frames, twc


def long_horizon_metrics(world, frames, twc, device):
    """The flagship and the naive static run over the long-horizon crowd
    on `device`, and tests/test_long_horizon_dynamic.py's numbers: both
    ATEs and states, the trajectories' first and last stamps, and the
    medians of joint, velocity and limb-length errors of the optimized
    long trajectories."""
    from airdos_tpu_torch.io.synthetic import BODY1, BODY2, _SKELETON_REST
    from airdos_tpu_torch.io.tum import ate_rmse
    from airdos_tpu_torch.slam.map import TH_LONG_TRAJECTORY
    from airdos_tpu_torch.slam.system import System

    runs = {}
    for tag, mask in (("flagship", True), ("naive", False)):
        slam = System(_long_horizon_config(mask, mask), device=device)
        per = _run(slam, frames)
        _, _, t_est = slam.tracking.trajectory_tum()
        runs[tag] = (slam, float(ate_rmse(t_est, twc[:len(t_est)])),
                     slam.tracking.state.name, per)
    slam = runs["flagship"][0]
    trajs = slam.map.trajectories
    first = np.asarray([t.poses[0].timestamp for t in trajs.values()])
    last = np.asarray([t.poses[-1].timestamp for t in trajs.values()])
    seg_gt = np.linalg.norm(_SKELETON_REST[BODY1] - _SKELETON_REST[BODY2],
                            axis=1)
    joint, vel, seg = [], [], []
    for tr in trajs.values():
        if not (tr.optimized and len(tr) > TH_LONG_TRAJECTORY):
            continue
        hu = world.humans[tr.track_id]
        for hp in tr.poses:
            ok = hp.optimized[:14] & ~hp.bad[:14]
            if ok.any():
                gt = hu.joints_at(hp.timestamp)
                joint.extend(np.linalg.norm(hp.joints_w[:14][ok]
                                            - gt[:14][ok], axis=1).tolist())
        vel.append(float(np.linalg.norm(tr.motion_t - hu.velocity)))
        opt = tr.segment_optimized & ~tr.segment_bad
        if opt.any():
            seg.extend(np.abs(tr.segment_len[opt]
                              - hu.scale * seg_gt[opt]).tolist())
    return dict(runs=runs, n_trajs=len(trajs), first=first, last=last,
                joint=float(np.median(joint)) if joint else float("inf"),
                vel=float(np.median(vel)) if vel else float("inf"),
                seg=float(np.median(seg)) if seg else 0.0)


def phase_long_horizon(smi: str, world, frames, twc):
    """tests/test_long_horizon_dynamic.py on the card, its bounds held."""
    _reset_counts()
    m = long_horizon_metrics(world, frames, twc, "cuda")
    counts = _counts()
    (_, ate_h, state_h, per_h), (_, ate_n, state_n, per_n) = \
        m["runs"]["flagship"], m["runs"]["naive"]
    t_end = (len(frames) - 1) * 0.1
    ended = int((m["last"] < t_end - 1.0).sum())
    started = int((m["first"] > 1.0).sum())
    slam = m["runs"]["flagship"][0]
    print(f"[long] {len(frames)}-frame crowd, small camera: flagship ATE "
          f"{ate_h:.6f} m ({state_h}), naive {ate_n:.6f} m ({state_n}), "
          f"ratio {ate_h / ate_n:.3f}; trajectories {m['n_trajs']} ({ended} "
          f"ended early, {started} started late); medians of the optimized "
          f"long trajectories: joint error {m['joint']:.4f} m, velocity "
          f"error {m['vel']:.4f}, limb-length error {m['seg']:.4f} m; human "
          f"BA solves {slam.human_ba.n_runs}; per-frame ms flagship "
          f"{_ms_stats([p[2] * 1e3 for p in per_h])}, naive "
          f"{_ms_stats([p[2] * 1e3 for p in per_n])}; launches {counts} on "
          f"{smi}", flush=True)
    misses = []
    if state_h != "OK":
        misses.append(f"flagship state {state_h}")
    if not (ate_h < 0.8 * ate_n and ate_h < 0.05):
        misses.append(f"ATE {ate_h} vs naive {ate_n} (< 0.8x and < 0.05 m)")
    if m["n_trajs"] < 4 or ended < 1 or started < 1:
        misses.append(f"{m['n_trajs']} trajectories, {ended} ended early, "
                      f"{started} started late")
    if not (m["joint"] < 0.5 and m["vel"] < 0.6 and m["seg"] < 0.15):
        misses.append(f"joint {m['joint']} (< 0.5), velocity {m['vel']} "
                      f"(< 0.6), limb {m['seg']} (< 0.15)")
    if misses:
        _fail("long horizon: " + "; ".join(misses))
    return counts


def _rank_launches(module, n: int, kernel: str) -> dict:
    """A kernel's launches since the last reset by mesh rank: rank 0 is
    this thread, rank r > 0 the thread Mesh.run names "<this>:rank<r>"."""
    me = threading.current_thread().name
    names = [me] + [f"{me}:rank{r}" for r in range(1, n)]
    by = collections.Counter()
    for (name, thread, _), k in module.launch_tally().items():
        if name == kernel:
            by[thread] += k
    return [by.get(name, 0) for name in names] + \
        [k for t, k in by.items() if t not in names]


def phase_multi_device(smi: str, frames, twc, crowd, crowd_twc):
    """Phase 16 (module docstring): airdos_tpu's Device.NChips paths on a
    mesh of 4 ranks (real cards when the machine has two or more, else 4
    virtual ranks on cuda:0 through AIRDOS_TORCH_VIRTUAL_DEVICES), held
    against the single-device phases.  Returns the sharded runs' launch
    counts."""
    import torch
    from airdos_tpu_torch import graft_entry
    from airdos_tpu_torch.convert import to_device
    from airdos_tpu_torch.ops import ba_global as bg
    from airdos_tpu_torch.ops import segment_kernels as sk
    from airdos_tpu_torch.parallel import mesh as pmesh
    from airdos_tpu_torch.parallel.sharded_ba import (
        make_mesh, sharded_local_bundle_adjust, sharded_sim3_ransac)
    from airdos_tpu_torch.slam.ba_driver import (pad_edge_table,
                                                 solve_global_ba)
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.solvers.global_ba import launches_per_step
    from airdos_tpu_torch.solvers.local_ba import local_bundle_adjust
    from airdos_tpu_torch.solvers.sim3 import sim3_ransac

    n_cards = torch.cuda.device_count()
    n = min(4, n_cards) if n_cards >= 2 else 4
    env_before = os.environ.get(pmesh.VIRTUAL_DEVICES_ENV)
    if n_cards < 2:
        os.environ[pmesh.VIRTUAL_DEVICES_ENV] = str(n)
    runs = collections.Counter()        # Mesh.run calls by sharded path
    plain_run = pmesh.Mesh.run

    def counted(self, fn, *args, **kwargs):
        runs[fn.__qualname__.split(".")[0]] += 1
        return plain_run(self, fn, *args, **kwargs)

    def each_rank(what: str, per_rank: int, module=sk,
                  kernel="segment_sum"):
        got = _rank_launches(module, n, kernel)
        if got != [per_rank] * n:
            _fail(f"multi-device {what}: {kernel} launches by rank "
                  f"{got}, not {per_rank} on each of {n}")

    def step_a(mesh):
        """The first static BA problem of phase mapping, sharded."""
        args = _FOR_MESH["static_ba"]
        run = sharded_local_bundle_adjust(mesh)
        # single, sharded, sharded, single: host ms of each solve
        ms_1, (single,) = _timed_device(lambda: local_bundle_adjust(*args),
                                        reps=1)
        _reset_counts()
        ms_4, outs = _timed_device(lambda: run(*args))
        counts = _counts()
        each_rank("a (local BA, two runs)", 2 * 45)
        ms_1 += _timed_device(lambda: local_bundle_adjust(*args), reps=1)[0]
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            _fail("multi-device a: two sharded local BA runs differ")
        o = outs[0]
        dR = float((o.R - single.R).abs().max())
        dt = float((o.t - single.t).abs().max())
        agree = float((o.edge_inlier == single.edge_inlier).float().mean())
        if not (dR < 2e-4 and dt < 2e-3 and agree > 0.98):
            _fail(f"multi-device a: sharded local BA vs single: R {dR}, "
                  f"t {dt} m, inlier agreement {agree}")
        E = args[5].shape[0]
        print(f"[multi-device] a: local BA C {args[0].shape[0]} P "
              f"{args[3].shape[0]} E {E} ({E // n} a rank): two sharded "
              f"runs bit-equal, {n} x 45 segment_sum "
              f"launches each; against the single-device solve R {dR:.2e}, "
              f"t {dt:.2e} m, inlier agreement {agree:.4f}; ms a solve "
              f"(single, sharded, sharded, single): "
              f"{[round(x * 1e3, 2) for x in ms_1[:1] + ms_4 + ms_1[1:]]}",
              flush=True)
        return counts

    def step_b(mesh):
        """System with n_chips over static-28's uint8 twins."""
        cfg = _bench_config()
        cfg.device.n_chips = n
        slam = System(cfg, device="cuda")
        _reset_counts()
        per = _track_static(slam, [_twin(d) for d in frames])
        counts = _counts()
        slam.shutdown()
        solves = slam.static_ba.n_solves
        bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
        kf_frames = [i for i, p in enumerate(per) if p["kf"]]
        no_ba = [i for i in kf_frames if per[i]["live0"] >= 2
                 and per[i]["solves"] != 1]
        seg_off = [i for i, p in enumerate(per)
                   if p["d"]["segment_sum"] != n * 45 * p["solves"]]
        ate = _ate(slam.tracking, twc)
        if bad or len(slam.map.kfs) < 5 or not ate < 0.02 or no_ba \
                or seg_off or runs["sharded_local_bundle_adjust"] != solves:
            _fail(f"multi-device b: frames not OK {bad}, keyframes "
                  f"{len(slam.map.kfs)}, ATE {ate} m, keyframes without a "
                  f"BA solve {no_ba}, frames with segment_sum != {n} x 45 "
                  f"a solve {seg_off}, sharded runs {dict(runs)} for "
                  f"{solves} solves")
        each_rank("b (static System)", 45 * solves)
        track_ms = [p["ms"] for p in per if not p["kf"]]
        kf_ms = [p["ms"] for i, p in enumerate(per) if p["kf"] and i > 0]
        print(f"[multi-device] b: static-28 System, Device.NChips {n}: "
              f"every frame OK, keyframes {len(slam.map.kfs)}, {solves} "
              f"sharded BA solves; ATE {ate:.6f} m (phase mapping "
              f"{_FOR_MESH['mapping_ate']:.6f} m); per-frame ms tracking "
              f"{_ms_stats(track_ms)}, keyframe frames {_ms_stats(kf_ms)}; "
              f"launches {counts}", flush=True)
        return counts

    def step_c(mesh):
        """The crowd-27 flagship with n_chips."""
        cfg = _human_bench_config()
        cfg.device.n_chips = n
        slam = System(cfg, device="cuda")
        _reset_counts()
        per = _track_human(slam, [_twin(d) for d in crowd])
        counts = _counts()
        slam.shutdown()
        bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
        missed = [i for i, p in enumerate(per)
                  if p["tick"] and p["human"] != 1]
        seg_off = [i for i, p in enumerate(per) if p["d"]["segment_sum"]
                   != n * (45 * p["static"] + 60 * p["human"])]
        ate = _ate(slam.tracking, crowd_twc)
        n_static, n_human = slam.static_ba.n_solves, slam.human_ba.n_runs
        if bad or missed or not any(p["tick"] for p in per) or seg_off \
                or not ate < 0.03 \
                or runs["sharded_human_bundle_adjust"] != n_human \
                or runs["sharded_local_bundle_adjust"] != n_static:
            _fail(f"multi-device c: frames not OK {bad}, ticks without a "
                  f"human BA {missed}, segment_sum off at {seg_off}, ATE "
                  f"{ate} m, sharded runs {dict(runs)} for {n_static} "
                  f"static and {n_human} human solves")
        each_rank("c (flagship)", 45 * n_static + 60 * n_human)
        hba = [p["ms"] for p in per if p["human"]]
        print(f"[multi-device] c: crowd-27 flagship, Device.NChips {n}: "
              f"every frame OK, {n_human} sharded human BA solves (one at "
              f"every cadence tick), {n_static} sharded static solves; ATE "
              f"{ate:.6f} m (phase human {_FOR_MESH['human_ate']:.6f} m); "
              f"human-BA frames {_ms_stats(hba)} ms; launches {counts}",
              flush=True)
        return counts

    def step_d(mesh):
        """The map-scale global BA in GlobalBA's schedule, sharded."""
        arrays, cam, R8, t8 = _FOR_MESH["map_scale"]
        E = len(arrays[5])
        padded = pad_edge_table(*arrays[5:9], -(-E // n) * n)[:5]
        dev = [to_device(a, "cuda") for a in tuple(arrays[:5]) + padded]
        dev0 = [to_device(a, "cuda") for a in arrays]
        _reset_counts()
        secs, outs = _timed_device(
            lambda: solve_global_ba(*dev, *cam, mesh=mesh))
        counts = _counts()
        per_step = launches_per_step(48)
        each_rank("d (global BA, two runs)", 2 * 20 * per_step["segment_sum"])
        for kernel in ("schur_point", "schur_camera"):
            each_rank("d (global BA, two runs, raw mode)",
                      2 * 20 * per_step[kernel], bg, kernel)
        (R1, t1, p1), (R2, t2, p2) = outs
        if not (torch.equal(R1, R2) and torch.equal(t1, t2)
                and torch.equal(p1, p2)):
            _fail("multi-device d: two sharded global BA runs differ")
        R, t = R1.cpu().numpy(), t1.cpu().numpy()
        moved = np.linalg.norm(t[1:] - arrays[1][1:], axis=1)
        chi0 = _chi2_sum(dev0, cam, dev0[0], dev0[1], dev0[3])
        chi1 = _chi2_sum(dev0, cam, R1, t1, p1)
        if not ((moved > 1e-5).all() and chi1 < 1e-2 * chi0):
            _fail(f"multi-device d: free keyframes moved "
                  f"{(moved > 1e-5).mean():.3f}, chi2 {chi0} -> {chi1}")
        ctr = -np.einsum("cij,ci->cj", R, t)
        ctr8 = -np.einsum("cij,ci->cj", R8, t8)
        print(f"[multi-device] d: map-scale global BA, C {len(arrays[0])}, "
              f"P {len(arrays[3])}, E {E} ({len(dev[5]) // n} a rank): "
              f"{[round(x, 3) for x in secs]} s per solve, two runs "
              f"bit-equal, each {n} x {20 * per_step['segment_sum']} "
              f"segment_sum launches and {n} x {20 * per_step['schur_point']}"
              f" schur_point and schur_camera in raw mode (the sums psummed, "
              f"Hpp^-1 and the CG update eager on every rank); chi2 "
              f"{chi0:.6g} -> {chi1:.6g}; largest gap to phase map "
              f"scale's single-device solve: R "
              f"{np.abs(R - R8).max():.2e}, t {np.abs(t - t8).max():.2e} m, "
              f"centre {np.linalg.norm(ctr - ctr8, axis=1).max():.2e} m",
              flush=True)
        return counts

    def step_e(mesh):
        """The blackout of phase reloc with n_chips."""
        cut, _ = _reloc_frames(frames, twc, blank=True)
        cfg = _bench_config()
        cfg.device.n_chips = n
        slam = System(cfg, device="cuda")
        _reset_counts()
        per = _track_static(slam, cut)
        counts = _counts()
        slam.shutdown()
        trk = slam.tracking
        states = [p["state"] for p in per]
        want = _FOR_MESH["reloc_frame"]
        if any(s != "OK" for s in states[:N_GOOD]) or \
                any(s != "LOST" for s in states[N_GOOD:N_GOOD + N_BLANK]) \
                or states[-1] != "OK" or trk.last_reloc_frame != want \
                or trk._sharded_pnp is None \
                or runs["sharded_epnp_ransac"] < 1 \
                or counts["epnp_hypotheses"] != \
                n * runs["sharded_epnp_ransac"] \
                or counts["epnp_refine"] != counts["epnp_hypotheses"]:
            _fail(f"multi-device e: states {states}, relocalized at "
                  f"{trk.last_reloc_frame} (phase reloc {want}), sharded "
                  f"runs {dict(runs)}")
        print(f"[multi-device] e: blackout, Device.NChips {n}: relocalized "
              f"at frame {trk.last_reloc_frame} as phase reloc, through "
              f"{runs['sharded_epnp_ransac']} sharded EPnP RANSAC calls "
              f"({trk.reloc_inliers} inliers), each an epnp_hypotheses and "
              f"an epnp_refine launch a rank; launches {counts}",
              flush=True)
        return counts

    def step_f(mesh):
        """Phase loop's Sim3 RANSAC, sharded: equal to sim3_ransac."""
        args, kwargs = _FOR_MESH["sim3"]
        single = sim3_ransac(*args, **kwargs)
        _sync()
        _reset_counts()
        sharded = sharded_sim3_ransac(mesh, **kwargs)(*args)
        _sync()
        counts = _counts()
        if counts["horn_hypotheses"] != n or counts["horn_refine"] != n:
            _fail(f"multi-device f: the sharded Sim3 RANSAC launched "
                  f"{counts['horn_hypotheses']} horn_hypotheses and "
                  f"{counts['horn_refine']} horn_refine, not one each a rank")
        differ = [f for f, x, y in zip(single._fields, sharded, single)
                  if not torch.equal(x, y)]
        if differ:
            _fail(f"multi-device f: sharded Sim3 RANSAC differs in {differ}")
        print(f"[multi-device] f: Sim3 RANSAC of phase loop's closed loop "
              f"({args[0].shape[0]} matches, {args[3].shape[0]} hypotheses)"
              f": sharded result equal to sim3_ransac (winner "
              f"{int(single.best)}, {int(single.n_inliers)} inliers), a "
              f"horn_hypotheses and a horn_refine launch a rank",
              flush=True)
        return counts

    def step_g(mesh):
        """graft_entry.dryrun_multichip on the card."""
        _reset_counts()
        graft_entry.dryrun_multichip(n, device="cuda")
        _sync()
        counts = _counts()
        each_rank("g (dry run)",
                  12 + 2 * launches_per_step(8)["segment_sum"] + 8)
        for kernel in ("schur_point", "schur_camera"):
            each_rank("g (dry run, raw mode)", 2 * 8, bg, kernel)
        print(f"[multi-device] g: graft_entry.dryrun_multichip({n}) passed; "
              f"launches {counts}", flush=True)
        return counts

    total = dict.fromkeys(_counts(), 0)
    pmesh.Mesh.run = counted
    try:
        mesh = make_mesh(n, "cuda")
        kind = "virtual ranks on one card" if mesh.virtual \
            else "a rank a card"
        print(f"[multi-device] mesh: {mesh.describe()} ({kind}) on {smi}",
              flush=True)
        for name, step in (("a", step_a), ("b", step_b), ("c", step_c),
                           ("d", step_d), ("e", step_e), ("f", step_f),
                           ("g", step_g)):
            runs.clear()
            t0 = time.perf_counter()
            counts = step(mesh)
            total = {k: total[k] + counts[k] for k in total}
            print(f"[time] multi-device {name} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        pmesh.Mesh.run = plain_run
        if env_before is None:
            os.environ.pop(pmesh.VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[pmesh.VIRTUAL_DEVICES_ENV] = env_before
    return total


def _phase(name, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _path_phases(smi: str, frames, twc, cli):
    """Render the other scenes (phase 14a's CLI runs meanwhile), then drive
    every main path with the kernels' launches recorded by shape.  Phases
    mapping and human get the frames quantized to uint8, as the drivers
    read them, so that their Systems are the drivers' in-memory twins.
    Returns the launches summed over the paths, and the loop closer's
    snapshot and extractor for phase loop replay."""
    crowd, crowd_twc = _phase("render crowd-27", _crowd_frames, N_CROWD)
    orbit, orbit_twc = _phase("render orbit-84", _orbit_frames, N_ORBIT)
    long_world, long_frames, long_twc = _phase("render long-110",
                                               _long_horizon_frames)
    memory = {}
    with _path_recording(), _triangulation_watch() as triangulations, \
            _geometry_watch() as geometry:
        _phase("slice", phase_slice, smi, frames, twc)
        launches = _phase("mapping", phase_mapping, smi,
                          [_twin(d) for d in frames], twc, memory)
        counts = [_phase("human", phase_human, smi,
                         [_twin(d) for d in crowd], crowd_twc, memory),
                  _phase("reloc", phase_reloc, smi, frames, twc)]
        loop, snap, extractor, offline_loop = _phase(
            "loop", phase_loop, smi, orbit, orbit_twc)
        counts += [loop, _phase("map scale", phase_map_scale, smi),
                   _phase("online", phase_online, smi, orbit, orbit_twc,
                          crowd, crowd_twc, frames, twc, offline_loop),
                   _phase("drivers", phase_drivers, smi, frames, twc, crowd,
                          crowd_twc, memory, cli),
                   _phase("long horizon", phase_long_horizon, smi,
                          long_world, long_frames, long_twc),
                   _phase("multi-device", phase_multi_device, smi, frames,
                          twc, crowd, crowd_twc)]
    for c in counts:
        launches = {k: launches[k] + c[k] for k in launches}
    tri_off = _triangulation_off(triangulations)
    if tri_off or not triangulations:
        _fail(f"triangulation calls (call, (epipolar match_rows, triangulate, "
              f"Hamming launches)) {tri_off[:8]} not (1, 1, 0), of "
              f"{len(triangulations)}")
    geo_off = _geometry_off(geometry)
    if geo_off:
        _fail(f"(call kind, call, launches) {geo_off[:8]} not one launch of "
              f"each of its kernels")
    print("[paths] " + "; ".join(
        f"{what}: {len(calls)} calls, each {want} launches of its kernels"
        for what, (calls, want) in geometry.items()), flush=True)
    ham = {k.name: launches[k.name] for k in KERNELS if k.off_path}
    if any(ham.values()):
        _fail(f"the paths launched the Hamming kernel: {ham}")
    print(f"[paths] triangulation: {len(triangulations)} calls, each one "
          f"epipolar match_rows and one triangulate launch; no path launched "
          f"the Hamming kernel {ham}", flush=True)
    return launches, (snap, extractor)


def main():
    t_start = time.perf_counter()
    smi = phase_environment()
    _phase("build", phase_build)
    if sys.argv[1:] == ["--profile"]:
        phase_profile(smi)
        return
    if sys.argv[1:]:
        _fail(f"usage: python3 chip_smoke.py [--profile], got {sys.argv[1:]}")
    frames, twc = _phase("render static-28", _bench_frames, N_FRAMES)
    with _kitti_cli(frames) as cli:
        launches, (snap, extractor) = _path_phases(smi, frames, twc, cli)
    rows = _phase("kernel", phase_kernel, smi)
    _phase("determinism", phase_determinism)
    _phase("loop replay", phase_loop_replay, snap, extractor)
    _phase("agreement", phase_cpu_agreement)
    print(f"[time] chip_smoke {time.perf_counter() - t_start:.1f} s",
          flush=True)

    import torch
    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[k.name],
                **rows[k.name]} for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
