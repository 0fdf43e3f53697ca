"""On the card: each cell at its full size for a short window, its result
line, and the control failing its limits. Skips without a card."""

import json

import pytest

from slambench import cell as cell_mod
from slambench import check, run

pytestmark = pytest.mark.cuda

CELLS = ["stereo.chunk_sweep"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_and_control_fails(cuda, name):
    cell = cell_mod.find_cell(name)
    r = cell_mod.run_cell(cell, 20261018, 8.0, True, device="cuda",
                          control=True, log=lambda *a: None)
    r["correct"], r["checks"] = check.verdict(r["numbers"], cell.limits)
    assert r["correct"], r["checks"]
    assert not check.verdict(r["control"], cell.limits)[0]
    line = run.result_line(cell, r, 1.0, True, "card",
                           lambda n: cell_mod.metric_reader(cell.root, n))
    line = json.loads(json.dumps(line))
    assert {"tracking_host_ms", "launches_per_frame", "idle_share",
            "b1_roofline"} <= set(line["metrics"])
    assert 0 < line["metrics"]["b1_roofline"]["value"] <= 100
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
