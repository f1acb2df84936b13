"""The port's dataset drivers and evaluator (airdos_tpu_torch.examples.*,
airdos_tpu_torch.tools.evaluate) on the CPU, against airdos_tpu's
examples/ and tools/evaluate.py.

Each driver runs with device="cpu" on tests/test_examples_cli.py's
8-frame small-camera sequence, written with cv2 in its dataset's layout,
through the reference-format YAML: it exits 0 and writes the reference's
columns (KITTI 12, TUM 8) and the SaveMap files.  Stated tolerance for
the stereo_human driver against airdos_tpu's examples/stereo_human.py on
the same files: tests/test_torch_slice.py's, the same number of poses and
an ATE to the ground truth within 10% or 2 mm of airdos_tpu's.  The
evaluator prints the same text as tools/evaluate.py (builtin backend).
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from airdos_tpu_torch.examples import (stereo_euroc, stereo_human,
                                       stereo_kitti, synthetic_demo)
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu_torch.io.tum import ate_rmse, read_trajectory_tum
from airdos_tpu_torch.tools import evaluate
from test_examples_cli import YAML
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
N = 8
# rectification blocks that leave the pinhole images as they are
IDENTITY_RECTIFICATION = "LEFT.width: 320\nLEFT.height: 240\n" + "".join(
    f"{side}.{key}: !!opencv-matrix\n   rows: {r}\n   cols: {c}\n   dt: d\n"
    f"   data: [{', '.join(map(str, data))}]\n"
    for side in ("LEFT", "RIGHT")
    for key, r, c, data in (
        ("K", 3, 3, [320.0, 0, 160.0, 0, 320.0, 120.0, 0, 0, 1]),
        ("D", 1, 5, [0.0] * 5),
        ("R", 3, 3, [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]),
        ("P", 3, 4, [320.0, 0, 160.0, 0, 0, 320.0, 120.0, 0, 0, 0, 1, 0])))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """test_examples_cli.py's sequence in the TartanAir / KITTI layout and
    the EuRoC layout, its settings YAMLs and ground truth (TUM)."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("drivers")
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=small_camera())
    seq = root / "seq"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    ts_lines, ns_lines, gt = [], [], []
    for i, (data, Rwc, twc) in enumerate(world.sequence(N, dt=0.1)):
        left = data.image_left.astype(np.uint8)
        right = data.image_right.astype(np.uint8)
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), left)
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), right)
        ns = str(int(round(data.timestamp * 1e9)) + 10 ** 18)
        for cam, img in (("cam0", left), ("cam1", right)):
            d = root / "euroc" / "mav0" / cam / "data"
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / f"{ns}.png"), img)
        ts_lines.append(f"{data.timestamp:.6f}")
        ns_lines.append(ns)
        gt.append(twc)
    (seq / "times.txt").write_text("\n".join(ts_lines) + "\n")
    (root / "ts_ns.txt").write_text("\n".join(ns_lines) + "\n")
    (root / "settings.yaml").write_text(YAML)
    (root / "euroc.yaml").write_text(YAML + IDENTITY_RECTIFICATION)
    ts = np.asarray([float(t) for t in ts_lines])
    gt = np.asarray(gt)
    (root / "gt.txt").write_text("".join(
        f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} 0 0 0 1\n"
        for t, p in zip(ts, gt)))
    return root, gt


def _rows(path):
    return [line.split() for line in path.read_text().strip().splitlines()]


@pytest.fixture(scope="module")
def human_runs(dataset):
    """The port's stereo_human driver (CPU) and airdos_tpu's
    examples/stereo_human.py (through runpy) on the same files."""
    root, _ = dataset
    args = [str(root / "settings.yaml"), str(root / "seq")]
    port = root / "traj_port.txt"
    assert stereo_human.main(args + [str(port), str(root / "dump_port")],
                             device="cpu") == 0
    ref = root / "traj_ref.txt"
    saved = sys.argv
    sys.argv = ["stereo_human.py"] + args + [str(ref), str(root / "dump_ref")]
    try:
        with pytest.raises(SystemExit) as ex:
            runpy.run_path(str(REPO / "examples" / "stereo_human.py"),
                           run_name="__main__")
        assert ex.value.code == 0
    finally:
        sys.argv = saved
    return port, ref


def test_stereo_human_driver_writes_tum_and_savemap(dataset, human_runs):
    root, _ = dataset
    port, _ = human_runs
    rows = _rows(port)
    assert len(rows) >= N - 1 and all(len(r) == 8 for r in rows)
    for f in ("KF.txt", "MP.txt", "Match.txt", "HMTraj.txt", "Motion.txt"):
        assert (root / "dump_port" / f).exists(), f


def test_stereo_human_driver_agrees_with_airdos_tpu(dataset, human_runs):
    _, gt = dataset
    port, ref = human_runs
    ts_p, _, t_p = read_trajectory_tum(port)
    ts_r, _, t_r = read_trajectory_tum(ref)
    assert np.array_equal(ts_p, ts_r)
    ate_p = ate_rmse(t_p, gt[:len(t_p)])
    ate_r = ate_rmse(t_r, gt[:len(t_r)])
    assert abs(ate_p - ate_r) <= max(0.1 * ate_r, 0.002), (ate_p, ate_r)


def test_stereo_kitti_driver_writes_kitti_rows(dataset, capsys):
    root, gt = dataset
    traj = root / "traj_kitti.txt"
    assert stereo_kitti.main([str(root / "settings.yaml"), str(root / "seq"),
                              str(traj), "--device", "cpu"]) == 0
    rows = np.asarray(_rows(traj), np.float64)
    assert rows.shape == (N, 12)
    assert ate_rmse(rows.reshape(N, 3, 4)[:, :, 3], gt) < 0.02
    assert "median tracking time:" in capsys.readouterr().out


def test_stereo_euroc_driver_with_identity_rectification(dataset,
                                                        human_runs):
    """Identity rectification keeps the images, so the EuRoC driver's
    poses equal the stereo_human driver's on the same frames (the YAML has
    Human.OK 0)."""
    root, _ = dataset
    traj = root / "traj_euroc.txt"
    assert stereo_euroc.main([str(root / "euroc.yaml"), str(root / "euroc"),
                              str(root / "ts_ns.txt"), str(traj)],
                             device="cpu") == 0
    rows = _rows(traj)
    assert len(rows) == N and all(len(r) == 8 for r in rows)
    np.testing.assert_array_equal(
        np.asarray(rows, np.float64)[:, 1:],
        np.asarray(_rows(human_runs[0]), np.float64)[:, 1:])


def test_synthetic_demo_writes_its_files(tmp_path):
    pytest.importorskip("matplotlib")
    assert synthetic_demo.main([str(tmp_path), "4", "--device", "cpu"]) == 0
    for tag in ("human", "static"):
        assert len(_rows(tmp_path / f"traj_{tag}.txt")) == 4
        assert (tmp_path / f"map_{tag}.png").stat().st_size > 1000
        assert (tmp_path / f"overlay_{tag}.png").exists()


def test_evaluate_prints_what_airdos_tpu_prints(dataset, human_runs, capsys,
                                                tmp_path):
    root, _ = dataset
    port, _ = human_runs
    args = ["--estimate", str(port), "--gt", str(root / "gt.txt")]
    evaluate.main(args)
    got = capsys.readouterr().out
    saved = sys.argv
    sys.argv = ["evaluate.py"] + args
    try:
        runpy.run_path(str(REPO / "tools" / "evaluate.py"),
                       run_name="__main__")
    finally:
        sys.argv = saved
    want = capsys.readouterr().out
    assert got == want and "(backend: builtin)" in got
    plot = tmp_path / "plot.png"
    pytest.importorskip("matplotlib")
    evaluate.main(args + ["--plot", str(plot)])
    assert plot.stat().st_size > 1000


@pytest.mark.parametrize("driver,n_args", [(stereo_kitti, 3),
                                           (stereo_human, 3),
                                           (stereo_euroc, 4)])
def test_drivers_print_usage_and_default_to_the_card(dataset, capsys, driver,
                                                     n_args):
    """Too few arguments print the usage and return 1; without a device
    argument the driver runs on the card, and where torch sees none it
    raises, never falling back to the CPU."""
    root, _ = dataset
    assert driver.main(["only-one"]) == 1
    assert "Usage:" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver would run on it")
    args = {3: [str(root / "settings.yaml"), str(root / "seq"),
                str(root / "never.txt")],
            4: [str(root / "euroc.yaml"), str(root / "euroc"),
                str(root / "ts_ns.txt"), str(root / "never.txt")]}[n_args]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        driver.main(args)
    assert not (root / "never.txt").exists()


def test_readers_drivers_and_viewer_import_no_jax_cv2_pil_or_matplotlib():
    """The card's machine has none of them: importing the readers, the
    drivers, the evaluator and the viewer pulls none in (matplotlib is
    imported only where a figure is drawn)."""
    import subprocess
    mods = ["airdos_tpu_torch.io", "airdos_tpu_torch.io.png",
            "airdos_tpu_torch.io.rectify", "airdos_tpu_torch.viz.viewer",
            "airdos_tpu_torch.viz.frame_drawer",
            "airdos_tpu_torch.examples.stereo_human",
            "airdos_tpu_torch.examples.stereo_kitti",
            "airdos_tpu_torch.examples.stereo_euroc",
            "airdos_tpu_torch.examples.synthetic_demo",
            "airdos_tpu_torch.tools.evaluate"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cv2', 'PIL', 'matplotlib', 'airdos_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
