"""Carry map, tracking and loop-closing state between the reference and
the port.

SLAM has no weights: the map, the tracking context, the vocabulary tree,
the loop closer's state and a global BA's snapshot are what two
implementations must share to compare one step from an identical start.
The reference's ``MapState``, ``TrackCarry``, ``Vocabulary``, ``LoopState``
(with the BoW index and its ``kf_node`` table), ``DenseGBAState`` and
``Frame`` arrive as dicts of numpy arrays (``jax.device_get(x._asdict())``; a nested MapState may also be a
NamedTuple of numpy arrays). ``uint32`` descriptor words travel as
``int32`` with the same bits. Every function that makes tensors takes the
device they go to; there is no default.

``config_from_dict`` carries a configuration over the same way: the
reference's frozen dataclasses arrive as ``dataclasses.asdict(cfg)``.
This module imports nothing of the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch import config
from orb_slam_2_ros_tpu_torch.frontend.extractor import Keypoints
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame
from orb_slam_2_ros_tpu_torch.map.state import MapState
from orb_slam_2_ros_tpu_torch.pipeline.loop_closing import LoopState
from orb_slam_2_ros_tpu_torch.pipeline.tracking import TrackCarry
from orb_slam_2_ros_tpu_torch.place.database import BowDatabase
from orb_slam_2_ros_tpu_torch.place.vocabulary import Vocabulary
from orb_slam_2_ros_tpu_torch.solvers.ba import DenseGBAState


def config_from_dict(d) -> config.SlamConfig:
    """The port's ``SlamConfig`` from ``dataclasses.asdict`` of a
    configuration tree with the same fields (the reference's, or the
    port's own). An unknown or missing field raises ``TypeError``."""
    def build(cls, vals):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        missing = sorted(set(fields) - set(vals))
        if missing:
            raise TypeError(f"{cls.__name__}: missing fields {missing}")
        kw = {}
        for name, v in vals.items():
            if name not in fields:
                raise TypeError(f"{cls.__name__} has no field {name!r}")
            sub = getattr(config, str(fields[name].type), None)
            kw[name] = build(sub, v) if dataclasses.is_dataclass(sub) else v
        return cls(**kw)
    return build(config.SlamConfig, d)


def _as_dict(d):
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (or number) as a tensor on ``device``; uint32 words
    as int32 with the same bits."""
    a = np.array(a)     # a writable copy, 0-d arrays stay 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def map_state_from_numpy(d, device) -> MapState:
    d = _as_dict(d)
    return MapState(**{f: to_tensor(d[f], device) for f in MapState._fields})


def track_carry_from_numpy(d, device) -> TrackCarry:
    d = _as_dict(d)
    vals = {f: to_tensor(d[f], device) for f in TrackCarry._fields if f != "m"}
    return TrackCarry(m=map_state_from_numpy(d["m"], device), **vals)


def vocabulary_from_numpy(d, device) -> Vocabulary:
    """A vocabulary tree (the reference's ``Vocabulary`` as a NamedTuple or
    dict: tensors for ``node_desc`` and ``word_weight``, plain integers
    for the rest)."""
    d = _as_dict(d)
    return Vocabulary(node_desc=to_tensor(d["node_desc"], device),
                      word_weight=to_tensor(d["word_weight"], device),
                      k=int(d["k"]), levels=int(d["levels"]),
                      levels_up=int(d["levels_up"]))


def bow_database_from_numpy(d, device) -> BowDatabase:
    d = _as_dict(d)
    return BowDatabase(**{f: to_tensor(d[f], device)
                          for f in BowDatabase._fields})


def loop_state_from_numpy(d, device) -> LoopState:
    d = _as_dict(d)
    vals = {f: to_tensor(d[f], device) for f in LoopState._fields if f != "db"}
    return LoopState(db=bow_database_from_numpy(d["db"], device), **vals)


def frame_from_numpy(d, device) -> Frame:
    """One frame's measurements (the reference's ``Frame``, its ``kps`` a
    nested ``Keypoints``), so that both sides can be fed the same
    keypoints."""
    d = _as_dict(d)
    kps = _as_dict(d["kps"])
    return Frame(kps=Keypoints(**{f: to_tensor(kps[f], device)
                                  for f in Keypoints._fields}),
                 **{f: to_tensor(d[f], device)
                    for f in Frame._fields if f != "kps"})


def dense_gba_state_from_numpy(d, device) -> DenseGBAState:
    d = _as_dict(d)
    return DenseGBAState(**{f: to_tensor(d[f], device)
                            for f in DenseGBAState._fields})


def to_numpy(x):
    """Port NamedTuple (MapState, TrackCarry, LoopState, Vocabulary, ...)
    -> dict of numpy arrays, nested NamedTuples as nested dicts, plain
    numbers as they are. ``desc`` fields (int32 words) come back as
    uint32, the reference's dtype."""
    out = {}
    for name, v in x._asdict().items():
        if hasattr(v, "_asdict"):
            out[name] = to_numpy(v)
            continue
        if not isinstance(v, torch.Tensor):
            out[name] = v
            continue
        a = v.detach().cpu().numpy()
        if name.endswith("desc") and a.dtype == np.int32:
            a = a.view(np.uint32)
        out[name] = a
    return out
