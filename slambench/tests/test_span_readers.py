"""The readers of the program's spans and counters: their arithmetic on a
hand-built context, and None where the program has no such span (the
parent of the change that adds them, or a cell that never calls them)."""

import pytest

from slambench import cell as cell_mod

from conftest import SLAMBENCH

SPANS = {"frontend_host_ms": "frontend",
         "track_search_host_ms": "tracking.search",
         "pose_solve_host_ms": "tracking.pose_solve",
         "tracking_wait_ms": "tracking.fetch"}


def _read(name, ctx):
    return cell_mod.metric_reader(SLAMBENCH, name)(ctx)


def _ctx(timers, frames=120):
    return {"frames": frames, "window_s": 60.0, "timers": timers}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_is_ms_per_frame(name):
    timers = {"tracking": (60.0, 8), SPANS[name]: (6.0, 480)}
    assert _read(name, _ctx(timers)) == pytest.approx(1e3 * 6.0 / 120)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_without_its_span(name):
    assert _read(name, _ctx({"tracking": (60.0, 8)})) is None
    assert _read(name, _ctx({SPANS[name]: (6.0, 480)}, frames=0)) is None


def test_useful_share():
    timers = {"tracking.pose_lm_iters": (0.0, 9600),
              "tracking.pose_lm_idle_iters": (0.0, 2400)}
    assert _read("pose_lm_useful_share", _ctx(timers)) == pytest.approx(0.75)
    timers["tracking.pose_lm_idle_iters"] = (0.0, 0)
    assert _read("pose_lm_useful_share", _ctx(timers)) == 1.0


@pytest.mark.parametrize("timers", [
    {}, {"tracking.pose_lm_iters": (0.0, 9600)},
    {"tracking.pose_lm_idle_iters": (0.0, 10)},
    {"tracking.pose_lm_iters": (0.0, 0),
     "tracking.pose_lm_idle_iters": (0.0, 0)}])
def test_useful_share_without_its_counters(timers):
    assert _read("pose_lm_useful_share", _ctx(timers)) is None
