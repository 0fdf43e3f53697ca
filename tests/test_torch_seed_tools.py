"""The tools that hold the two packages' full-system passes side by side at
any seed: the port's ``eval_loop_closing.py`` (``--seed``, ``--vocab``,
``--mesh``), ``tools/reference_passes.py`` (``--seed``, ``--vocab``, the
``vocab`` mode) and ``tools/hard_divergence.py compare`` on the ``loop``,
``loop --mesh`` and ``hard`` passes.

Every check is exact: parsed flags, the vocabulary a tool loads (node
descriptors bit for bit, weights equal in float32), the first chunk where
two logs part and the counts of their last entries.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu.config import SlamConfig, VocabConfig
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import eval_loop_closing as elc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_loop_closing_flags():
    a = elc.build_parser().parse_args([])
    assert (a.seed, a.vocab, a.mesh, a.device, a.out) == (
        0, None, False, "cuda", elc.OUT)
    assert not (a.skip_hard or a.hard_only)
    a = elc.build_parser().parse_args(
        ["--seed", "2", "--vocab", "v.npz", "--mesh", "--device", "cpu",
         "--out", "x.json"])
    assert (a.seed, a.vocab, a.mesh, a.device, a.out) == (
        2, "v.npz", True, "cpu", "x.json")


def test_eval_loop_closing_means_the_card(monkeypatch):
    """Without ``--device cpu`` the run needs the card and exits before it
    renders anything."""
    rendered = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(elc, "render_frames",
                        lambda *a, **k: rendered.append(a) or 1 / 0)
    for argv in ([], ["--seed", "1"], ["--mesh"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            elc.main(argv)
    assert not rendered


def test_both_packages_load_one_vocabulary_file(tmp_path):
    """The file ``reference_passes.py vocab`` writes is what both sides
    load: ``reference_passes._vocabulary`` and the port's ``load_npz``
    (as ``eval_loop_closing --vocab``) give the same tree."""
    rp = _tool("reference_passes")
    cfg = SlamConfig(vocab=VocabConfig(k=4, levels=2))
    descs = np.random.default_rng(3).integers(0, 2 ** 32, (400, 8),
                                              dtype=np.uint32)
    voc = jvoc.train_vocabulary(descs, cfg, seed=1)
    path = str(tmp_path / "v.npz")
    jvoc.save_npz(voc, path)
    ref = rp._vocabulary(cfg, 1, path)
    from orb_slam_2_ros_tpu_torch.place import vocabulary as tvoc
    port = tvoc.load_npz(path, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.node_desc),
                                  np.asarray(voc.node_desc))
    np.testing.assert_array_equal(
        port.node_desc.numpy().view(np.uint32), np.asarray(voc.node_desc))
    np.testing.assert_array_equal(port.word_weight.numpy(),
                                  np.asarray(voc.word_weight))
    assert (port.k, port.levels, port.levels_up) == (
        ref.k, ref.levels, ref.levels_up) == (4, 2, voc.levels_up)


def _entry(chunk, **kw):
    e = {"chunk": chunk, "ok": 16, "keyframe_rows": 3, "keyframes_valid": 3,
         "map_points": 1000, "dispatched": [-1, 2], "consumed": [],
         "ladder_runs": [], "ladders": 0, "loops_closed": 0,
         "gba_started": 0, "gba_finished": 0, "gba_rejected": 0,
         "gba_aborts": 0, "gba_running": False}
    e.update(kw)
    return e


@pytest.mark.parametrize("ref_pass,port_pass", sorted(
    _tool("hard_divergence").PORT_PASS.items()))
def test_compare_finds_where_two_logs_part(tmp_path, ref_pass, port_pass):
    hd = _tool("hard_divergence")
    ref_chunks = [_entry(0), _entry(1, map_points=1100),
                  _entry("flush", ok=224, loops_closed=1, gba_finished=1,
                         ladder_runs=[[3, 14, True, 153]], ladders=1)]
    port_chunks = [_entry(0), _entry(1, map_points=1096),
                   _entry("flush", ok=224, ladder_runs=[[3, 14, True, 150]],
                          ladders=1)]
    ref = {"pass": ref_pass, "seed": 1, "chunks": ref_chunks,
           "ate_composed_m": 0.3}
    decoy = {"pass": "decoy", "chunks": [], "ate_composed_m": 9.0}
    port = {"passes": [decoy, {"pass": port_pass, "chunks": port_chunks,
                               "ate_composed_m": 0.2}]}
    with open(tmp_path / "ref.out", "w") as f:
        f.write("progress line\n" + json.dumps(ref) + "\n")
    with open(tmp_path / "port.json", "w") as f:
        json.dump(port, f)
    out = hd.compare(str(tmp_path / "ref.out"), str(tmp_path / "port.json"))
    assert out["pass"] == ref_pass and out["seed"] == 1
    assert out["first_chunk_differing_per_field"] == {
        "map_points": 1, "loops_closed": "flush", "ladder_runs": "flush",
        "gba_finished": "flush"}
    assert out["ladders_differ_only_in_inliers"]
    assert out["reference"] == {"ok": 224, "loops_closed": 1,
                                "gba_finished": 1, "gba_rejected": 0}
    assert out["port"] == {"ok": 224, "loops_closed": 0, "gba_finished": 0,
                           "gba_rejected": 0}
    assert (out["reference_ate_composed_m"], out["port_ate_composed_m"]) == (
        0.3, 0.2)
