"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a run on the CPU but the look for a card
(``run_cell`` with ``device="cpu"``), on the cells cut to a size the CPU
holds (``conftest.tiny_tree``), once sound and once for each fault these
cells can have: a step that returns its state unchanged (the pose solver
hands back its starting pose), half of the batch left out (every other keypoint
of every frame dropped), and an answer altered where it is produced (one
of B1's distances; in the stereo cell, every right coordinate the stereo
search returns, by one pixel). They have no exchange between chips to
leave out.
The control, the references one precision lower, must fail too
(``test_control_is_not_correct``).
"""

import contextlib
import math
import os

import pytest
import torch

from slambench import cell as cell_mod
from slambench import check

from conftest import CELLS, tiny_tree

SEED = 20261018


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_tree(str(tmp_path_factory.mktemp("tiny")))


@contextlib.contextmanager
def solver_returns_its_start():
    from orb_slam_2_ros_tpu_torch.pipeline import tracking
    orig = tracking.pose_optimization

    def stuck(q0, t0, *args):
        _, _, inlier, n = orig(q0, t0, *args)
        return q0, t0, inlier, n
    tracking.pose_optimization = stuck
    try:
        yield
    finally:
        tracking.pose_optimization = orig


@contextlib.contextmanager
def half_the_keypoints():
    from orb_slam_2_ros_tpu_torch.frontend import extractor
    orig = extractor.extract_with_pyramid

    def half(img, cfg):
        kps, pyramid = orig(img, cfg)
        keep = torch.arange(kps.valid.shape[0], device=kps.valid.device) % 2 == 0
        return kps._replace(valid=kps.valid & keep), pyramid
    extractor.extract_with_pyramid = half
    try:
        yield
    finally:
        extractor.extract_with_pyramid = orig


@contextlib.contextmanager
def altered_b1_answer():
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    orig = matcher.masked_best_two

    def altered(*args):
        bi, bd, si, sd = orig(*args)
        bd = bd.clone()
        bd[0] += 1
        return bi, bd, si, sd
    matcher.masked_best_two = altered
    try:
        yield
    finally:
        matcher.masked_best_two = orig


@contextlib.contextmanager
def altered_right_coordinates():
    from orb_slam_2_ros_tpu_torch.frontend import stereo
    orig = stereo.compute_stereo_matches

    def altered(*args):
        u_right, depth = orig(*args)
        return torch.where(u_right >= 0, u_right + 1.0, u_right), depth
    stereo.compute_stereo_matches = altered
    try:
        yield
    finally:
        stereo.compute_stereo_matches = orig


def run(bench, name, fault=None, control=False):
    root = os.path.join(os.path.dirname(bench), "slambench")
    cell = cell_mod.find_cell(name, bench, root)
    with fault() if fault else contextlib.nullcontext():
        r = cell_mod.run_cell(cell, SEED, 2.0, False, device="cpu",
                              control=control, log=lambda *a: None)
    return r, cell


@pytest.fixture(autouse=True)
def keep_more_b1_calls(monkeypatch):
    # a CPU window makes a few dozen B1 calls: keep more
    monkeypatch.setattr(cell_mod, "CAPTURE_EVERY", 3)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(bench, name):
    r, cell = run(bench, name)
    ok, rows = check.verdict(r["numbers"], cell.limits)
    assert r["frames"] > 0 and r["numbers"].get("b1_wrong") == 0
    assert ok, rows


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault,trips", [
    (solver_returns_its_start, "pose_dev_um"),
    (half_the_keypoints, "kp_mismatch"),
    (altered_b1_answer, "b1_wrong")])
def test_fault_is_not_correct(bench, name, fault, trips):
    r, cell = run(bench, name, fault)
    ok, rows = check.verdict(r["numbers"], cell.limits)
    assert not ok
    # the number the fault should trip reads above its limit, or none can
    # be read (a stereo map never made on half the keypoints)
    v = r["numbers"][trips]
    assert not math.isfinite(v) or v > cell.limits[trips], rows


def test_altered_right_coordinates_are_not_correct(bench):
    r, cell = run(bench, "stereo.chunk_sweep", altered_right_coordinates)
    ok, rows = check.verdict(r["numbers"], cell.limits)
    assert not ok and r["numbers"]["ur_err_px"] > cell.limits["ur_err_px"]


def test_a_solve_that_was_not_seen_is_not_correct(bench, monkeypatch):
    # a design that moves the frame's last solve away from the captured
    # call site leaves its frames unchecked: the run is not correct
    monkeypatch.setattr(cell_mod, "SOLVES_PER_FRAME", 3)
    r, cell = run(bench, "stereo.chunk_sweep")
    assert math.isnan(r["numbers"]["pose_dev_um"])
    assert not check.verdict(r["numbers"], cell.limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, name):
    r, cell = run(bench, name, control=True)
    assert not check.verdict(r["control"], cell.limits)[0]
    if name == "stereo.chunk_sweep":
        full = cell_mod.find_cell(name)
        assert not check.verdict(r["control"], full.limits)[0]
