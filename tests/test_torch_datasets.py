"""The port's sequence readers and rectification against airdos_tpu's,
which read with OpenCV, on the CPU.

- Rectification maps (io/rectify.py) within 1e-3 px of
  cv2.initUndistortRectifyMap (measured: equal to the last bit on both
  calibrations below); ``remap_linear`` equal to cv2.remap(INTER_LINEAR)
  on every pixel, no tolerance.
- Sequences written with cv2 in the TartanAir, KITTI and EuRoC layouts:
  every FrameData field of each port class equals airdos_tpu's on the
  same directory (arrays equal, dtypes equal), including the recovery
  rules (no times.txt, a missing image, a missing detection file,
  use_tracked_id off, a settings file without rectification blocks).
"""
import dataclasses

import numpy as np
import pytest

import airdos_tpu.io.datasets as jds
import airdos_tpu_torch.io.datasets as tds
from airdos_tpu_torch.io.rectify import (init_undistort_rectify_map,
                                         remap_linear)
from test_euroc import YAML as SMALL_EUROC_YAML
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

cv2 = pytest.importorskip("cv2")

# cam0 and cam1 of the reference's Examples/Stereo/EuRoC.yaml (752x480)
EUROC = {
    "LEFT.K": [[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
               [0.0, 0.0, 1.0]],
    "LEFT.D": [[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]],
    "LEFT.R": [[0.999966347530033, -0.001422739138722922, 0.008079580483432283],
               [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
               [-0.008089410156878961, -0.007044357138835809,
                0.9999424675829176]],
    "LEFT.P": [[435.2046959714599, 0, 367.4517211914062, 0],
               [0, 435.2046959714599, 252.2008514404297, 0], [0, 0, 1, 0]],
    "RIGHT.K": [[457.587, 0.0, 379.999], [0.0, 456.134, 255.238],
                [0.0, 0.0, 1]],
    "RIGHT.D": [[-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]],
    "RIGHT.R": [[0.9999633526194376, -0.003625811871560086,
                 0.007755443660172947],
                [0.003680398547259526, 0.9999684752771629,
                 -0.007035845251224894],
                [-0.007729688520722713, 0.007064130529506649,
                 0.999945173484644]],
    "RIGHT.P": [[435.2046959714599, 0, 367.4517211914062, -47.90639384423901],
                [0, 435.2046959714599, 252.2008514404297, 0], [0, 0, 1, 0]],
}


def _euroc_yaml(blocks, width, height) -> str:
    lines = ["%YAML:1.0", f"LEFT.width: {width}", f"LEFT.height: {height}"]
    for key, m in blocks.items():
        m = np.asarray(m, np.float64)
        lines += [f"{key}: !!opencv-matrix", f"   rows: {m.shape[0]}",
                  f"   cols: {m.shape[1]}", "   dt: d",
                  "   data: [" + ", ".join(repr(float(v)) for v in m.ravel())
                  + "]"]
    return "\n".join(lines) + "\n"


def _texture(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    t = 128 + 90 * np.sin(x / 5.0 + y / 13.0) + rng.normal(0, 20, (h, w))
    return np.clip(t, 0, 255).astype(np.uint8)


def _assert_frames_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype \
                and a.shape == b.shape and np.array_equal(a, b), f.name
        else:
            assert a == b and type(a) is type(b), f.name


@pytest.mark.parametrize("calib", ["test_euroc", "euroc_752x480"])
def test_rectification_maps_and_remap_equal_opencv(tmp_path, calib):
    if calib == "test_euroc":
        path = tmp_path / "e.yaml"
        path.write_text(SMALL_EUROC_YAML)
        c = jds.read_opencv_yaml_matrices(path)
        size = (64, 48)
    else:
        c = {k: np.asarray(v, np.float64) for k, v in EUROC.items()}
        size = (752, 480)
    rng = np.random.default_rng(size[0])
    img = _texture(rng, size[1], size[0])
    for side in ("LEFT", "RIGHT"):
        args = (c[f"{side}.K"], c[f"{side}.D"], c[f"{side}.R"],
                c[f"{side}.P"][:3, :3])
        mx, my = init_undistort_rectify_map(*args, size)
        cx, cy = cv2.initUndistortRectifyMap(*args, size, cv2.CV_32F)
        assert mx.dtype == np.float32 and mx.shape == cx.shape
        assert np.abs(mx - cx).max() <= 1e-3
        assert np.abs(my - cy).max() <= 1e-3
        want = cv2.remap(img, cx, cy, cv2.INTER_LINEAR)
        assert np.array_equal(remap_linear(img, cx, cy), want)
        assert np.array_equal(remap_linear(img, mx, my), want)


def test_remap_equals_opencv_off_the_image_and_on_grid_points():
    """Maps that leave the image on every side (BORDER_CONSTANT 0), on
    whole and half pixels, and random."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    mx = rng.uniform(-4, 54, (40, 50)).astype(np.float32)
    my = rng.uniform(-4, 44, (40, 50)).astype(np.float32)
    mx[::3] = np.round(mx[::3] * 2) / 2
    my[::4] = np.round(my[::4])
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    assert np.array_equal(remap_linear(img, mx, my), want)


def test_rectification_refuses_other_distortion_models():
    K = np.eye(3)
    with pytest.raises(ValueError, match="8 terms"):
        init_undistort_rectify_map(K, np.zeros(8), np.eye(3), K, (4, 4))


def _tartanair(root, n, rng, colour_frame=1):
    """A TartanAir-layout sequence of n frames written with cv2: gray
    images (one BGR), segmentation, AlphaPose detections (frame 2 has no
    files), track ids and times.txt."""
    for d in ("image_0", "image_1", "rcnnseg_image_0", "rcnnseg_image_1",
              "alphapose_0", "alphapose_1", "track_id_alpha"):
        (root / d).mkdir(parents=True)
    for i in range(n):
        name = f"{i:06d}"
        for side in "01":
            img = _texture(rng, 24, 32)
            if i == colour_frame:
                img = np.stack([img, img[::-1], 255 - img], -1)
            cv2.imwrite(str(root / f"image_{side}" / f"{name}.png"), img)
            seg = (rng.random((24, 32)) < 0.2).astype(np.uint8) * 255
            cv2.imwrite(str(root / f"rcnnseg_image_{side}" / f"{name}.png"),
                        seg)
            if i != 2:
                dets = rng.uniform(0, 30, (2, 54))
                np.savetxt(root / f"alphapose_{side}" / f"{name}.txt", dets)
        if i != 2:
            np.savetxt(root / "track_id_alpha" / f"{name}.txt",
                       np.asarray([3, -1]), fmt="%d")
    (root / "times.txt").write_text(
        "".join(f"{0.1 * i + 1e9:.6f}\n" for i in range(n)))


@pytest.mark.parametrize("variant", ["full", "no_track_ids", "no_times",
                                     "missing_image", "window"])
def test_tartanair_sequence_equals_airdos_tpu(tmp_path, variant):
    rng = np.random.default_rng(11)
    _tartanair(tmp_path, 4, rng)
    kw = {}
    if variant == "no_track_ids":
        kw["use_tracked_id"] = False
    if variant == "no_times":
        (tmp_path / "times.txt").unlink()
    if variant == "missing_image":
        (tmp_path / "image_1" / "000003.png").unlink()
        (tmp_path / "rcnnseg_image_0" / "000000.png").unlink()
    if variant == "window":
        kw.update(start=1, end=3)
    want = jds.TartanAirStereoSequence(tmp_path, **kw)
    got = tds.TartanAirStereoSequence(tmp_path, **kw)
    assert len(got) == len(want) and got.timestamps == want.timestamps
    frames_w, frames_g = list(want), list(got)
    assert len(frames_g) == len(frames_w)
    for g, w in zip(frames_g, frames_w):
        _assert_frames_equal(g, w)
    by_index = {f.index: f for f in frames_g}
    if 2 in by_index:               # no detection files: [0, 18, 3]
        assert by_index[2].humans_left.shape == (0, 18, 3)
    if variant == "no_track_ids":
        assert all(f.track_ids is None for f in frames_g)
    if variant == "missing_image":
        assert by_index[3].image_right is None
        assert by_index[0].seg_left is None
    if variant == "no_times":
        assert got.timestamps == [0.0, 0.5, 1.0, 1.5]


def test_kitti_sequence_equals_airdos_tpu(tmp_path):
    rng = np.random.default_rng(5)
    _tartanair(tmp_path, 3, rng)
    want = list(jds.KittiStereoSequence(tmp_path, start=1))
    got = list(tds.KittiStereoSequence(tmp_path, start=1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_frames_equal(g, w)
        assert g.seg_left is None and g.humans_left is None


@pytest.mark.parametrize("calib", ["test_euroc", "euroc_752x480", "none"])
def test_euroc_sequence_equals_airdos_tpu(tmp_path, calib):
    if calib == "test_euroc":
        settings, (w, h) = SMALL_EUROC_YAML, (64, 48)
    else:
        settings, (w, h) = _euroc_yaml(EUROC, 752, 480), (752, 480)
    yaml = tmp_path / "euroc.yaml"
    yaml.write_text(settings)
    rng = np.random.default_rng(w)
    names = ["1403636579763555584", "1403636579813555456"]
    for cam in ("cam0", "cam1"):
        d = tmp_path / "mav0" / cam / "data"
        d.mkdir(parents=True)
        for name in names:
            img = _texture(rng, h, w)
            if cam == "cam1" and name == names[1]:
                img = np.stack([img, img // 2, 255 - img], -1)   # colour
            cv2.imwrite(str(d / f"{name}.png"), img)
    ts = tmp_path / "ts.txt"
    ts.write_text("".join(n + "\n" for n in names))
    yaml_arg = None if calib == "none" else yaml
    want = list(jds.EurocStereoSequence(tmp_path, ts, settings_yaml=yaml_arg))
    got = list(tds.EurocStereoSequence(tmp_path, ts, settings_yaml=yaml_arg))
    assert len(got) == len(want) == 2
    for g, wf in zip(got, want):
        _assert_frames_equal(g, wf)
    assert got[0].timestamp == 1403636579.763555584


def test_opencv_yaml_and_missing_blocks_match_airdos_tpu(tmp_path):
    yaml = tmp_path / "e.yaml"
    yaml.write_text(SMALL_EUROC_YAML)
    got, want = tds.read_opencv_yaml_matrices(yaml), \
        jds.read_opencv_yaml_matrices(yaml)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    bad = tmp_path / "bad.yaml"
    bad.write_text("%YAML:1.0\nCamera.fx: 400.0\n")
    ts = tmp_path / "ts.txt"
    ts.write_text("5\n")
    for mod in (jds, tds):
        with pytest.raises(ValueError, match="rectification blocks"):
            mod.EurocStereoSequence(tmp_path, ts, settings_yaml=bad)
