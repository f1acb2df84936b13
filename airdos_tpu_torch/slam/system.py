"""System facade — the public API (reference: src/System.cc, System.h:75-149).

    cfg = SlamConfig()                      # or SlamConfig.from_yaml(...)
    slam = System(cfg)                      # on the card; device="cpu"
                                            # use_viewer=True: viz.Viewer
    for data in sequence:                   # io.datasets.FrameData
        slam.track_stereo_human(data)       # or track_stereo(...)
    slam.before_end("map_dump_dir")         # optional SaveMap metadata dump
    slam.shutdown()
    slam.save_trajectory_tum("traj.txt")

This runs airdos_tpu's System: tracking (relocalizing when LOST), and at
each new keyframe the local-mapping pass (point culling, triangulation,
fusion, Schur local BA, keyframe culling, the scene vocabulary trained at
the first keyframes, or the one ``vocabulary_path`` names, and the
keyframe database that BoW tracking and relocalization read), then, with
loop closing active, loop closing (detection, Sim3, correction through
the essential graph and the global BA).  With Human.ok the human layer
runs too: masked ORB extraction (System.IsMask), stereo human
association, human poses entering the map, and the human-trajectory BA
every Camera.fps frames.  ``save_map`` / ``load_map`` checkpoint the map
in airdos_tpu's format; ``reset``, ``activate_localization_mode`` /
``deactivate_localization_mode`` and ``prefetch`` are airdos_tpu's.

Offline (``system.is_offline``, the paper configuration) every step runs
inline in the caller's thread, on its current CUDA stream, and two runs
are byte-identical.  Online, as the reference's threads (System.cc:87-96,
173-174): tracking runs in the caller's thread on a high-priority CUDA
stream; the mapping pass and loop closing run in a worker thread fed by a
queue, and keyframe insertion waits on its state; the human BA and the
global BA after a loop run in background threads, the global BA
abortable by a later loop or ``reset``; each worker launches on its own
stream of priority 0 and takes the map lock only around its host map
sections, and the objects alive at the start stay out of the garbage
collector's scans until ``shutdown`` (utils/gate.py).  For a caller that
feeds frames faster than the workers run, two departures from airdos_tpu: while keyframes wait in its
queue the mapping worker skips fusion, the static BA and keyframe
culling, as the reference's LocalMapping::Run does; and a human BA a whole
cadence period late makes tracking wait for it.  One more deliberate
deviation: airdos_tpu's worker
prints a failed keyframe's traceback and carries on; this one carries on
too, but keeps the first exception, which ``drain_mapping`` and
``shutdown`` raise, as ``HumanLocalBA.join`` does, so a worker's fault
cannot scroll past.  Online runs are not byte-deterministic.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.io.datasets import FrameData
from airdos_tpu_torch.io.tum import write_trajectory_kitti, write_trajectory_tum
from airdos_tpu_torch.slam.ba_driver import (Fuser, GlobalBA, HumanLocalBA,
                                             StaticLocalBA, Triangulator)
from airdos_tpu_torch.slam.frame import FrontEnd
from airdos_tpu_torch.slam.local_mapping import LocalMapper
from airdos_tpu_torch.slam.map import SlamMap
from airdos_tpu_torch.slam.tracking import Tracking, TrackState
from airdos_tpu_torch.utils.gate import (TRACKING_PRIORITY, WORKER_PRIORITY,
                                         TrackingGate, freeze_heap,
                                         new_stream, on_stream, thaw_heap)
from airdos_tpu_torch.utils.obs import EventLog, Profiler, span


class System:
    def __init__(self, config: SlamConfig, device="cuda",
                 use_viewer: bool = False):
        self.config = config
        self.map = SlamMap()
        self.frontend = FrontEnd(config, device=device)
        self.device = self.frontend.device
        self.local_mapper = LocalMapper(config, self.map)
        self.tracking = Tracking(config, self.frontend, self.map,
                                 self.local_mapper)
        online = not config.system.is_offline
        # the tracking <-> worker guard; offline everything runs in one
        # thread and the drivers take no lock
        self._map_lock = self.tracking.map_lock
        lock = self._map_lock if online else None
        ext = self.frontend.extractor
        self.static_ba = StaticLocalBA(config, self.map, ext,
                                       device=self.device, map_lock=lock)
        self.global_ba = GlobalBA(config, self.map, ext, device=self.device)
        self.local_mapper.triangulator = Triangulator(
            config, self.map, ext, self.local_mapper, device=self.device,
            map_lock=lock)
        self.local_mapper.fuser = Fuser(config, self.map, ext,
                                        device=self.device, map_lock=lock)
        self.human_ba = HumanLocalBA(config, self.map, ext,
                                     device=self.device, map_lock=lock) \
            if config.human.ok else None
        self._frame_count = 0
        self._last_human_ba_frame = 0
        self.track_times: List[float] = []
        # the host-side viewer, fed each tracked frame in the caller's
        # thread (online too), as airdos_tpu's System
        self.viewer = None
        if use_viewer:
            from airdos_tpu_torch.viz.viewer import Viewer
            self.viewer = Viewer(self.map, self.tracking)
        # per-stage host spans (AIRDOS_TRACE_DIR adds torch.profiler traces
        # on start/stop_device_trace) and the structured event log
        self.profiler = Profiler(trace_dir=os.environ.get("AIRDOS_TRACE_DIR"))
        self.events = EventLog(path=os.environ.get("AIRDOS_EVENT_LOG"))
        self.static_ba.profiler = self.profiler
        self.global_ba.profiler = self.profiler
        self.local_mapper.fuser.profiler = self.profiler
        self.tracking.profiler = self.profiler
        self.tracking.events = self.events
        if self.human_ba is not None:
            self.human_ba.profiler = self.profiler
        self._map_queue = None        # online: keyframes for the worker
        self._map_thread = None
        self._worker_error = None     # the worker's first exception
        self._track_stream = None     # online, on the card
        self._heap_frozen = False     # online: a freeze_heap hold
        if online:
            self._start_online()
        # place recognition: the vocabulary vocabulary_path names (by
        # suffix, as the reference's System.cc:56-67), or a scene
        # vocabulary trained lazily from the first keyframes' descriptors;
        # then the keyframe database and the loop closer
        self.vocabulary = None
        self.keyframe_db = None
        self.loop_closer = None
        if config.vocabulary_path:
            from airdos_tpu_torch.bow.vocabulary import (Vocabulary,
                                                         load_dbow2_binary,
                                                         load_dbow2_text)
            p = str(config.vocabulary_path)
            load = (Vocabulary.load_npz if p.endswith(".npz")
                    else load_dbow2_binary if p.endswith(".bin")
                    else load_dbow2_text)
            self.vocabulary = load(p, device=self.device)
            self._init_place_recognition()
        if online:
            # a garbage collection over the objects alive now would hold
            # the interpreter lock against tracking (utils/gate.py)
            freeze_heap()
            self._heap_frozen = True

    def _start_online(self):
        """The online threading: the tracking gate and stream, the mapping
        worker and its queue, keyframe insertion gated on the queue."""
        gate = TrackingGate()
        self.tracking.device_gate = gate
        for drv in (self.static_ba, self.global_ba,
                    self.local_mapper.triangulator, self.local_mapper.fuser,
                    self.human_ba):
            if drv is not None:
                drv.gate = gate
        self._track_stream = new_stream(self.device, TRACKING_PRIORITY)
        self._map_queue = queue.Queue()
        # keyframe-insertion gating (reference AcceptKeyFrames /
        # KeyframesInQueue, Tracking.cc:1101-1121): idle = no queued and
        # no in-flight keyframe (unfinished_tasks counts both)
        self.tracking.mapping_idle_fn = \
            lambda: self._map_queue.unfinished_tasks == 0
        self.tracking.mapping_queue_len_fn = self._map_queue.qsize
        if self.device.type == "cuda":
            # what the constructors put on the card, on this thread's
            # stream, is complete before other streams read it
            torch.cuda.synchronize(self.device)
        self._map_thread = threading.Thread(target=self._mapping_worker,
                                            daemon=True, name="mapping")
        self._map_thread.start()

    # ----------------------------------------------------------------- api
    def track_stereo(self, data: FrameData):
        """TrackStereo — static-only stereo tracking."""
        return self._track(data)

    def track_stereo_human(self, data: FrameData):
        """TrackStereoHuman — stereo + dynamic-human pipeline."""
        return self._track(data)

    def drain_mapping(self, timeout: float = 30.0) -> bool:
        """Block until the mapping worker has processed every queued
        keyframe (online; True at once offline).  Returns False on timeout.
        Raises the worker's first exception.  Paces a producer that can
        outrun real time (the reference's stereo_human.cc main loop sleeps
        to the dataset timestamp, which lets LocalMapping drain)."""
        if self._map_queue is None:
            return True
        done = self._wait_mapping_idle(timeout)
        self._raise_worker_error()
        return done

    def _wait_mapping_idle(self, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.perf_counter() + timeout
        while self._map_queue.unfinished_tasks:
            if deadline is not None and time.perf_counter() > deadline:
                return False
            time.sleep(0.002)
        return True

    def _raise_worker_error(self):
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def activate_localization_mode(self):
        """Track against the frozen map: no keyframe is inserted and the
        mapping pass gets nothing (reference System::
        ActivateLocalizationMode, System.cc:288-296)."""
        with self._map_lock:
            self.tracking.only_tracking = True

    def deactivate_localization_mode(self):
        with self._map_lock:
            self.tracking.only_tracking = False

    def reset(self):
        """User-triggered full reset (reference System::Reset, serviced by
        Tracking::Reset, Tracking.cc:1656-1705): stop the background work,
        clear the keyframe database and the map, restart tracking from
        scratch.  A running global BA is aborted, the queued keyframes
        are dropped and the one in flight is waited out (the reference's
        LocalMapping::RequestReset handshake; airdos_tpu lets it finish
        into the cleared map), and the human BA is joined, all without the
        map lock, which the workers need to finish."""
        self.global_ba.interrupt(wait=True)
        if self._map_queue is not None:
            while True:
                try:
                    self._map_queue.get_nowait()
                except queue.Empty:
                    break
                self._map_queue.task_done()
            self._wait_mapping_idle(None)
            # the keyframe that was in flight may have closed a loop
            self.global_ba.interrupt(wait=True)
        if self.human_ba is not None:
            self.human_ba.join()      # no write-back into a cleared map
        with self._map_lock:
            self.tracking._reset()
            if self.keyframe_db is not None:
                self.keyframe_db.clear()
            if self.loop_closer is not None:
                self.loop_closer._consistent_groups = []
                self.loop_closer._last_loop_kf = -1e9
            self._last_human_ba_frame = self._frame_count
        self.events.emit("reset")

    def prefetch(self, data: FrameData):
        """Begin the device upload of a future frame's images so that the
        copy overlaps the current frame's work: call with frame i + 1
        before tracking frame i (FrontEnd.prefetch)."""
        if data.image_left.ndim == 3 or data.image_right.ndim == 3:
            data = dataclasses.replace(data,
                                       image_left=self._to_gray(data.image_left),
                                       image_right=self._to_gray(data.image_right))
        self.frontend.prefetch(data)

    def _init_place_recognition(self):
        from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
        from airdos_tpu_torch.slam.loop_closing import LoopCloser
        self.keyframe_db = KeyFrameDatabase(self.vocabulary, self.map)
        self.tracking.keyframe_db = self.keyframe_db
        self.local_mapper.keyframe_db = self.keyframe_db
        self.loop_closer = LoopCloser(
            self.config, self.map, self.keyframe_db, self.frontend.extractor,
            self.device, fuser=self.local_mapper.fuser,
            global_ba=self.global_ba,
            map_lock=None if self._map_queue is None else self._map_lock)
        self.loop_closer.gate = self.tracking.device_gate
        self.loop_closer.profiler = self.profiler
        self.loop_closer.events = self.events
        for kf in self.map.kfs.values():
            if not kf.bad:
                self.keyframe_db.add(kf)

    def _maybe_train_vocabulary(self):
        """Train a small scene vocabulary from the first keyframes'
        descriptors (the reference instead loads the 145 MB ORBvoc.txt)."""
        if self.vocabulary is not None or self.map.n_keyframes() < 1:
            return
        from airdos_tpu_torch.bow.vocabulary import train_vocabulary
        descs = []
        for kf in self.map.kfs.values():
            d = kf.desc32[kf.valid]
            descs.append(d.view(np.uint8).reshape(len(d), 32))
        train = np.concatenate(descs, axis=0)
        if len(train) < 200:
            return
        self.vocabulary = train_vocabulary(train, k=8, depth=3,
                                           device=self.device)
        self._init_place_recognition()

    def _mapping_pipeline(self, prev_kf):
        """The per-keyframe local-mapping steps (reference: LocalMapping::Run
        body): inline offline, in the mapping worker online.  The map lock
        is held per step, never across the whole pass (the reference takes
        Map::mMutexMapUpdate inside each routine), so the tracking thread's
        short map sections interleave; triangulation, fusion and the static
        BA take it themselves around assembly and write-back and release it
        across their device work, and loop closing runs outside it (the
        reference's own LoopClosing thread).  Online, fusion, and the static
        BA with keyframe culling, are skipped while more keyframes wait in
        the queue, as the reference's LocalMapping::Run skips
        SearchInNeighbors, and LocalBundleAdjustment with KeyFrameCulling,
        while CheckNewKeyFrames() (LocalMapping.cc:49-126): so the worker
        catches up with a tracker that outruns it instead of refusing its
        keyframes until tracking is lost.  airdos_tpu runs every step."""
        lm = self.local_mapper
        with span(self.profiler, "map.cull_points"), self._map_lock:
            lm.cull_map_points(prev_kf.id)
        with span(self.profiler, "map.triangulate"):
            lm.create_new_points(prev_kf)
        if not self._keyframes_waiting():
            with span(self.profiler, "map.fuse"):
                lm.fuse_neighbors(prev_kf)
        # the static local BA at every keyframe once the map has three
        # (see airdos_tpu's System._mapping_pipeline for why per keyframe)
        refine = not self._keyframes_waiting()
        if refine and self.map.n_keyframes() > 2:
            with span(self.profiler, "map.static_ba"):
                self.static_ba(prev_kf)
        with self._map_lock:
            if refine:
                with span(self.profiler, "map.cull_kfs"):
                    lm.cull_keyframes(prev_kf)
            with span(self.profiler, "map.vocab"):
                self._maybe_train_vocabulary()
            if self.keyframe_db is None or prev_kf.bad:
                return
            if not self.config.loop_closing_active:
                self.keyframe_db.add(prev_kf)
                return
        with span(self.profiler, "map.loop_closing"):
            self.loop_closer.process(prev_kf)

    def _keyframes_waiting(self) -> bool:
        """Online: more keyframes are queued for the mapping worker
        (reference LocalMapping::CheckNewKeyFrames); never offline.  The
        worker's stop sentinel is queued only once it is idle."""
        return self._map_queue is not None and self._map_queue.qsize() > 0

    def _mapping_worker(self):
        """The online mapping thread: the pass for each queued keyframe on
        the worker's own CUDA stream.  A keyframe whose pass raised is
        marked done like the others and the worker carries on; the first
        exception is kept for drain_mapping / shutdown to raise (the
        deliberate deviation in the module docstring)."""
        with on_stream(new_stream(self.device, WORKER_PRIORITY)):
            while True:
                kf = self._map_queue.get()
                if kf is None:
                    self._map_queue.task_done()
                    return
                try:
                    self._mapping_pipeline(kf)
                except Exception as e:
                    if self._worker_error is None:
                        self._worker_error = e
                finally:
                    # until here the tracker sees mapping as busy
                    # (AcceptKeyFrames == false)
                    self._map_queue.task_done()

    def _to_gray(self, img: np.ndarray) -> np.ndarray:
        """Color -> grayscale honoring Camera.RGB channel order (reference
        Tracking.cc:247-272)."""
        if img.ndim == 2:
            return img
        w = np.asarray([0.299, 0.587, 0.114], np.float32)
        if not self.config.camera.rgb:      # BGR input
            w = w[::-1]
        return img[..., :3].astype(np.float32) @ w

    def _track(self, data: FrameData):
        """One frame; online, inside the tracking gate's frame, which the
        background global BA waits out (utils/gate.py)."""
        gate = self.tracking.device_gate
        if gate is None:
            return self._track_frame(data)
        with gate.frame():
            return self._track_frame(data)

    def _track_frame(self, data: FrameData):
        if data.image_left.ndim == 3 or data.image_right.ndim == 3:
            data = dataclasses.replace(data,
                                       image_left=self._to_gray(data.image_left),
                                       image_right=self._to_gray(data.image_right))
        t0 = time.perf_counter()
        with span(self.profiler, "track"), on_stream(self._track_stream):
            frame = self.tracking.track(data)
        prev_kf = self.map.kfs.get(self.tracking.last_kf_id)
        if (self.tracking.state == TrackState.OK and prev_kf is not None
                and not self.tracking.only_tracking
                and prev_kf.frame_id == frame.index):
            if self._map_queue is not None:
                self._map_queue.put(prev_kf)
            else:
                self._mapping_pipeline(prev_kf)

        # human-trajectory local BA every max_frames frames (OffLineTrack,
        # Tracking.cc:705-717)
        if (self.human_ba is not None
                and not self.config.optimizer.is_static_only
                and self.tracking.state == TrackState.OK
                and self._frame_count - self._last_human_ba_frame >=
                self.tracking.max_frames
                and self.map.long_trajectories()):
            if self._map_queue is not None:
                # online: the solve overlaps tracking in its own thread; a
                # still-running solve skips this tick, retried next frame,
                # until a whole cadence late: then tracking waits for it,
                # so the human BA keeps within one period of a tracker
                # that outruns it
                if self._frame_count - self._last_human_ba_frame >= \
                        2 * self.tracking.max_frames:
                    with span(self.profiler, "human_ba.wait"):
                        self.human_ba.join()
                if self.human_ba.launch(self.tracking.last_kf_id):
                    self._last_human_ba_frame = self._frame_count
            else:
                # offline: synchronous and deterministic
                with span(self.profiler, "human_ba"):
                    self.human_ba(self.map, self.tracking.last_kf_id)
                self._last_human_ba_frame = self._frame_count

        self._frame_count += 1
        dt = time.perf_counter() - t0
        self.track_times.append(dt)
        self.events.emit("frame", index=data.index,
                         state=self.tracking.state.name,
                         branch=self.tracking.last_branch,
                         n_inliers=int(self.tracking.n_inliers),
                         n_kfs=self.map.n_keyframes(),
                         n_points=self.map.n_points(),
                         track_s=round(dt, 4))
        if self.viewer is not None:
            self.viewer.update(frame)
        return frame

    # ------------------------------------------------------------- export
    def save_trajectory_tum(self, path: str):
        ts, Rwc, twc = self.tracking.trajectory_tum()
        write_trajectory_tum(path, ts, Rwc, twc)

    def save_keyframe_trajectory_tum(self, path: str):
        kfs = sorted((kf for kf in self.map.kfs.values() if not kf.bad),
                     key=lambda k: k.id)
        ts = [kf.timestamp for kf in kfs]
        Rwc = np.asarray([kf.Rwc for kf in kfs])
        twc = np.asarray([kf.Ow for kf in kfs])
        write_trajectory_tum(path, ts, Rwc, twc)

    def save_trajectory_kitti(self, path: str):
        ts, Rwc, twc = self.tracking.trajectory_tum()
        write_trajectory_kitti(path, Rwc, twc)

    def before_end(self, out_dir: Optional[str] = None):
        """Tracking::SaveMap metadata dump (KF/MP/Match/HMTraj/Motion .txt,
        reference Tracking.cc:1745-1836), in airdos_tpu's format.  With no
        explicit directory the dump goes to Data.MetaDataPath."""
        if out_dir is None:
            out_dir = self.config.meta_data_path or None
        if out_dir is None:
            return
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        pt = self.map.points
        with open(out / "KF.txt", "w") as f:
            for kf in sorted(self.map.kfs.values(), key=lambda k: k.id):
                if kf.bad:
                    continue
                q = _rot_to_quat_wxyz(kf.Rwc)
                ow = kf.Ow
                f.write(f"{kf.id} {kf.timestamp:.6f} "
                        f"{ow[0]:.7f} {ow[1]:.7f} {ow[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
        with open(out / "MP.txt", "w") as f:
            for pid in pt.live_ids():
                p = pt.pos[pid]
                f.write(f"{pid} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f}\n")
        with open(out / "Match.txt", "w") as f:
            for pid in pt.live_ids():
                for kf_id, fid in pt.obs[pid].items():
                    kf = self.map.kfs.get(kf_id)
                    if kf is None or kf.bad:
                        continue
                    u, v = kf.xy_un[fid]
                    ur = kf.u_right[fid]
                    isig = 1.0 / (self.frontend.extractor.sigma2[kf.octave[fid]])
                    f.write(f"{pid} {kf_id} {u:.3f} {v:.3f} {ur:.3f} {isig:.5f}\n")
        with open(out / "HMTraj.txt", "w") as f:
            for tid, traj in sorted(self.map.trajectories.items()):
                for i, hp in enumerate(traj.poses):
                    for j in range(hp.joints_w.shape[0]):
                        p = hp.joints_w[j]
                        f.write(f"{tid} {i} {j} {hp.timestamp:.6f} "
                                f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                                f"{int(hp.bad[j])} {int(hp.lost[j])} "
                                f"{int(hp.optimized[j])}\n")
        with open(out / "Motion.txt", "w") as f:
            for tid, traj in sorted(self.map.trajectories.items()):
                R, t = traj.motion_R, traj.motion_t
                row = " ".join(f"{v:.7f}" for v in
                               np.hstack([R, t[:, None]]).reshape(-1))
                f.write(f"{tid} {row}\n")

    def save_map(self, path: str):
        """Checkpoint the whole map (keyframes, points, humans) to one .npz
        in airdos_tpu's format."""
        from airdos_tpu_torch.slam.map import save_map
        with self._map_lock:
            save_map(self.map, path)

    def load_map(self, path: str):
        """Resume from a checkpoint (this package's or airdos_tpu's):
        tracking starts LOST and relocalizes against the loaded map.  The
        keyframe database is rebuilt from the loaded keyframes (a System
        without a vocabulary trains its scene vocabulary from them);
        airdos_tpu leaves its database as it was, so a fresh airdos_tpu
        System stays LOST after load_map."""
        from airdos_tpu_torch.slam.map import load_map
        with self._map_lock:
            self.map.__dict__.update(load_map(path).__dict__)
            self.tracking.state = TrackState.LOST
            self.tracking.last_kf_id = max(self.map.kfs) if self.map.kfs \
                else -1
            if self.vocabulary is None:
                self._maybe_train_vocabulary()
            elif self.keyframe_db is not None:
                self.keyframe_db.clear()
                for kf in self.map.kfs.values():
                    if not kf.bad:
                        self.keyframe_db.add(kf)

    def shutdown(self):
        """Stop the mapping worker once it has processed the keyframes
        queued, wait for the background human BA and global BA, then for
        the card, and thaw the heap frozen at the start (online); raises
        the first exception one of them raised."""
        joins = [self._join_mapping_worker, self.global_ba.join]
        if self.human_ba is not None:
            joins.insert(1, self.human_ba.join)
        first = None
        for join in joins:
            try:
                join()
            except Exception as e:          # every join runs first
                first = first or e
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._heap_frozen:
            self._heap_frozen = False
            thaw_heap()
        if self.viewer is not None:
            self.viewer.close()
        if first is not None:
            raise first

    def _join_mapping_worker(self):
        if self._map_thread is not None:
            self._wait_mapping_idle(None)   # the last keyframes in full
            self._map_queue.put(None)
            self._map_thread.join()
            self._map_thread = None
        self._raise_worker_error()

    # ------------------------------------------------------------- stats
    def timing_report(self):
        tt = sorted(self.track_times)
        n = len(tt)
        if n == 0:
            return {"median_s": 0.0, "mean_s": 0.0}
        return {"median_s": tt[n // 2], "mean_s": sum(tt) / n}


def _rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as _R
    q = _R.from_matrix(R).as_quat()  # x, y, z, w
    return np.array([q[3], q[0], q[1], q[2]])
