"""Configurations, traffic mixes, limits and metrics are found by name, and
one added only as files and entries runs through the same lookups."""

import json
import os
import re
import shutil

import pytest

from slambench import cell as cell_mod
from slambench import check
from slambench import stream

from conftest import REPO, SLAMBENCH

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_units_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    for entry in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
        for k in ("why", "layer", "source"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(SLAMBENCH, "metrics",
                                           m["name"] + ".py"))
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    names = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        cell = cell_mod.find_cell(w["name"])
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} == {"fps", "setup_s"}
        assert cell.limits and set(cell.limits) <= set(check.NAMES)
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= names
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            d = json.load(f)
        assert d["name"] == c["name"] and d["reduced"] == c["reduced"] == []


def test_unknown_workload():
    with pytest.raises(KeyError):
        cell_mod.find_cell("rgbd.nothing")


def test_a_cell_added_as_files_only(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, each
    a new file plus entries in BENCHMARK.json, and no edit of any file
    the harness has."""
    root = tmp_path / "slambench"
    shutil.copytree(SLAMBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    b = _bench()
    with open(root / "configs" / "stereo_ros.json") as f:
        cfg = json.load(f)
    cfg["name"] = "rgbd_wide"
    cfg["slam_config"]["sensor"] = 2
    cfg["slam_config"]["orb"]["n_features"] = 2000
    (root / "configs" / "rgbd_wide.json").write_text(json.dumps(cfg))
    with open(root / "traffic" / "chunk_sweep.json") as f:
        tr = json.load(f)
    tr["trajectory"] = "loop"
    tr["trajectory_frames"] = 224
    tr["frames"] = 112
    (root / "traffic" / "loop_sweep.json").write_text(json.dumps(tr))
    (root / "limits" / "rgbd.loop_sweep.json").write_text(
        json.dumps({"b1_wrong": 0}))
    (root / "metrics" / "frames_in_window.py").write_text(
        "def read(ctx):\n    return ctx['frames']\n")
    b["configs"].append({"name": "rgbd_wide", "source": "x",
                         "file": "slambench/configs/rgbd_wide.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "rgbd.loop_sweep", "config": "rgbd_wide",
                           "traffic": "loop_sweep", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "frames_in_window", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "fps",
                           "workloads": ["rgbd.loop_sweep"]})
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(b))
    cell = cell_mod.find_cell("rgbd.loop_sweep", str(bench), str(root))
    assert cell.config["slam_config"]["orb"]["n_features"] == 2000
    assert stream.image_of(cell.traffic, 120) == 102
    assert cell.limits == {"b1_wrong": 0}
    assert [m["name"] for m in cell.per_layer] == ["frames_in_window"]
    assert cell_mod.metric_reader(str(root), "frames_in_window")(
        {"frames": 7}) == 7
    old = cell_mod.find_cell("stereo.chunk_sweep", str(bench), str(root))
    assert "frames_in_window" not in [m["name"] for m in old.per_layer]
