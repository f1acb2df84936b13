"""The port's viewer and frame drawer (airdos_tpu_torch/viz) against
airdos_tpu's, on the CPU.

``draw_frame`` gets the same frame fields in both packages and must give
the same pixels (no tolerance); the viewer records a camera centre per
tracked frame through ``System(..., use_viewer=True)``, keeps overlays,
writes a PPM overlay without matplotlib and a map figure with it.
"""
import types

import numpy as np
import pytest

from airdos_tpu.viz.frame_drawer import draw_frame as jax_draw_frame
from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu_torch.slam.system import System
from airdos_tpu_torch.viz.frame_drawer import draw_frame, save_frame_overlay
from airdos_tpu_torch.viz.viewer import Viewer
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)


def _cfg():
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


@pytest.fixture(scope="module")
def viewer_run():
    """Six static small-camera frames through System(use_viewer=True) on
    the CPU, the viewer keeping overlays."""
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=small_camera())
    frames = [d for d, _, _ in world.sequence(6, dt=0.1)]
    slam = System(_cfg(), device="cpu", use_viewer=True)
    slam.viewer.keep_overlays = True
    last = [slam.track_stereo(d) for d in frames][-1]
    slam.shutdown()
    return slam, frames, last


def test_system_viewer_records_every_frame(viewer_run, tmp_path):
    slam, frames, last = viewer_run
    v = slam.viewer
    assert isinstance(v, Viewer) and len(v.poses) == len(frames)
    assert np.allclose(v.poses[-1], last.Ow)
    assert len(v.frame_overlays) == len(frames)
    assert v.frame_overlays[-1].shape == (240, 320, 3)
    fig = tmp_path / "map.png"
    v.set_ground_truth(np.asarray(v.poses) + 0.01)
    v.save_map_figure(str(fig))
    assert fig.exists() and fig.stat().st_size > 1000
    out = tmp_path / "overlay.ppm"
    img = save_frame_overlay(str(out), last, image=frames[-1].image_left)
    assert out.read_bytes() == b"P6\n320 240\n255\n" + img.tobytes()


def test_draw_frame_equals_airdos_tpu_on_a_tracked_frame(viewer_run):
    slam, frames, last = viewer_run
    args = (slam.tracking.state.name, slam.map.n_keyframes(),
            slam.map.n_points())
    got = draw_frame(last, *args, image=frames[-1].image_left)
    want = jax_draw_frame(last, *args, image=frames[-1].image_left)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    green = (got[..., 1] > 180) & (got[..., 0] < 100)
    assert green.sum() > 50
    assert np.array_equal(draw_frame(last, *args), jax_draw_frame(last, *args))


def test_draw_frame_equals_airdos_tpu_on_vo_points_and_humans():
    """Map matches, VO matches (coded <= -2), outliers, points at the
    border and human joints, some bad."""
    rng = np.random.default_rng(3)
    n = 60
    xy = rng.uniform(-5, [325, 245], (n, 2))
    mp_idx = rng.choice([-1, -2, 5, 17], n)
    humans = [types.SimpleNamespace(kp_left=rng.uniform(0, [320, 240],
                                                         (18, 2)),
                                    bad=rng.random(18) < 0.3)
              for _ in range(2)]
    frame = types.SimpleNamespace(
        xy=xy, mp_idx=mp_idx, valid=rng.random(n) < 0.9,
        outlier=rng.random(n) < 0.2, humans=humans,
        camera=types.SimpleNamespace(width=320, height=240))
    image = rng.uniform(0, 300, (240, 320)).astype(np.float32)
    for state in ("OK", "LOST"):
        got = draw_frame(frame, state, 7, 1234, image=image)
        want = jax_draw_frame(frame, state, 7, 1234, image=image)
        assert np.array_equal(got, want)
