"""The port's end-to-end run on the checked-in mini TUM sequence
(``tests/data/mini_tum``, 20 frames of 640x480 gray PNGs and 16-bit depth
PNGs with a ground truth), through the user's entry point on the CPU:
``run.main(["--device", "cpu", "--dataset", "tum", ...])`` decodes the
frames with the native library, streams them through the prefetcher in
wire format, tracks them with loop closing off and writes the trajectory,
the keyframe trajectory and the debug image.

Bars, those of ``tests/test_tum_e2e.py``: at most 2 frames not OK, the ATE
of the composed trajectory against ``groundtruth.txt`` below 0.05 m. The
saved TUM file reads back to the composed trajectory within its printed
precision (1e-6). The same frames decoded one by one into float images and
tracked by ``System`` give records bit for bit equal to the wire run's.
"""

import os

import numpy as np
import torch
from PIL import Image

from orb_slam_2_ros_tpu_torch import presets, run
from orb_slam_2_ros_tpu_torch.io.datasets import TumRGBD
from orb_slam_2_ros_tpu_torch.io.trajectory import ate_rmse, read_tum
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "data", "mini_tum")


def test_cli_on_the_mini_tum_sequence(tmp_path):
    out = {k: str(tmp_path / f"{k}.txt") for k in ("traj", "kf")}
    img_path = str(tmp_path / "debug.png")
    res = run.main(["--device", "cpu", "--dataset", "tum", "--path", ROOT,
                    "--no-loop-closing", "--save-traj", out["traj"],
                    "--save-kf-traj", out["kf"],
                    "--save-debug-image", img_path])
    system, n = res["system"], res["frames"]
    assert n == len(TumRGBD(ROOT)) == 20
    assert res["ok"] >= n - 2, res["ok"]
    assert res["ate_dataset_m"] < 0.05, res["ate_dataset_m"]

    ts, poses = read_tum(out["traj"])
    want, want_ts = system.tracker.composed_trajectory()
    np.testing.assert_allclose(ts, want_ts, atol=1e-6)
    est = np.stack([c for _, c in poses])
    np.testing.assert_allclose(est, np.stack([c for _, c in want]), atol=1e-6)
    gt = np.loadtxt(os.path.join(ROOT, "groundtruth.txt"))
    row = {round(t, 4): i for i, t in enumerate(gt[:, 0])}
    idx = [row[round(t, 4)] for t in ts]
    assert ate_rmse(est, gt[idx, 1:4]) < 0.05
    assert len(open(out["kf"]).read().splitlines()) == int(
        system.tracker.map.kf_valid.sum())
    assert np.asarray(Image.open(img_path)).shape == (500, 640, 3)

    # the indexed float path gives the wire run's records
    ds = TumRGBD(ROOT)
    float_sys = System(presets.get("tum1"), enable_loop_closing=False,
                       device="cpu")
    float_sys.track_chunk(np.stack([ds[i][0] for i in range(n)]),
                          np.stack([ds[i][1] for i in range(n)]),
                          ds.timestamps)
    assert [r.state for r in float_sys.records] == [
        r.state for r in system.records]
    assert sum(r.state == OK for r in float_sys.records) == res["ok"]
    for a, b in zip(float_sys.records, system.records):
        np.testing.assert_array_equal(a.c_w, b.c_w)
        np.testing.assert_array_equal(a.R_wc, b.R_wc)
