"""The last line's keys and what the per-layer readers return."""

import json

from slambench import cell as cell_mod
from slambench import check, run


def _run(trace):
    ctx = {"hand_in": 16, "single": False, "frames": 120, "window_s": 30.5,
           "call_s": [4.0] * 7 + [8.0],
           "timers": {"tracking": (27.0, 120), "local_mapping": (2.5, 120),
                      "loop_closing": (0.6, 120)},
           "mapping_steps": 10, "trace": None}
    if trace:
        ctx["trace"] = {"window_s": 8.0, "frames": 24, "launches": 540000,
                        "busy_s": 0.9, "device_ops": {"k1": 0.5, "k2": 0.4},
                        "idle_gaps": {"tracking": 6.0, "harness": 1.1},
                        "b1_calls": 100, "b1_bound_s": 1e-4,
                        "b1_device_s": 1e-3}
    numbers = {"kp_mismatch": 0.0, "desc_bits": 0.0, "b1_wrong": 0,
               "pose_dev_um": 1.0, "ur_err_px": 0.01, "mp_ray_mm": 1.0,
               "rpe_t_mm": 5.0, "rpe_r_mrad": 2.0, "ate_mm": 20.0}
    r = {"attempted": 120, "failed": 0, "frames": 120, "window_s": 30.5,
         "memory_peak_bytes": 123, "ctx": ctx, "numbers": numbers}
    cell = cell_mod.find_cell("stereo.chunk_sweep")
    r["correct"], r["checks"] = check.verdict(numbers, cell.limits)
    reader = lambda n: cell_mod.metric_reader(cell.root, n)  # noqa: E731
    return run.result_line(cell, r, 17.5, trace, "NVIDIA H100", reader)


def test_untraced_line():
    line = json.loads(json.dumps(_run(False)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"fps", "setup_s"}
    assert line["metrics"]["fps"] == {"value": 120 / 30.5, "unit": "frames/s"}
    assert line["metrics"]["setup_s"]["value"] == 17.5
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100",
                              "count": 1, "memory_peak_bytes": 123}
    assert set(line["checks"]) == set(
        cell_mod.find_cell("stereo.chunk_sweep").limits)
    assert line["checks"]["b1_wrong"] == {"value": 0, "limit": 0}


def test_traced_line():
    line = _run(True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(m) == {"tracking_host_ms", "loop_closing_host_ms",
                      "b1_roofline", "launches_per_frame", "idle_share"}
    assert m["tracking_host_ms"] == 1e3 * 27.0 / 120
    assert abs(m["b1_roofline"] - 10.0) < 1e-9
    assert m["launches_per_frame"] == 22500
    assert abs(m["idle_share"] - (1 - 0.9 / 8.0)) < 1e-12
    assert line["device"]["busy_s"] == 0.9 and line["device"]["window_s"] == 8.0
    assert line["breakdown"]["device_ops"] == [["k1", 0.5], ["k2", 0.4]]
    assert line["breakdown"]["idle_gaps"][0] == ["tracking", 6.0]


def test_a_failed_check_makes_the_run_incorrect():
    ok, rows = check.verdict({"b1_wrong": 1, "rpe_t_mm": 0.1},
                             {"b1_wrong": 0, "rpe_t_mm": 1.0})
    assert not ok and rows == [("b1_wrong", 1, 0), ("rpe_t_mm", 0.1, 1.0)]
    ok, _ = check.verdict({"rpe_t_mm": float("nan")}, {"rpe_t_mm": 1.0})
    assert not ok
    # a number the run could not read is not correct
    ok, rows = check.verdict({"rpe_t_mm": 0.1}, {"b1_wrong": 0,
                                                 "rpe_t_mm": 1.0})
    assert not ok and rows == [("b1_wrong", None, 0), ("rpe_t_mm", 0.1, 1.0)]
    ok, rows = check.verdict({"rpe_t_mm": 0.1}, {"rpe_t_mm": 1.0})
    assert ok and rows == [("rpe_t_mm", 0.1, 1.0)]
