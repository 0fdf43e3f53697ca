"""Carry map and tracking state between the reference and the port.

SLAM has no weights: the map and the tracking context are what two
implementations must share to compare one step from an identical start.
The reference's ``MapState`` and ``TrackCarry`` arrive as dicts of numpy
arrays (``jax.device_get(x._asdict())``; a nested MapState may also be a
NamedTuple of numpy arrays). ``uint32`` descriptor words travel as
``int32`` with the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.map.state import MapState
from orb_slam_2_ros_tpu_torch.pipeline.tracking import TrackCarry


def _as_dict(d):
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)     # a writable copy, 0-d arrays stay 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def map_state_from_numpy(d, device=None) -> MapState:
    d = _as_dict(d)
    return MapState(**{f: _to_tensor(d[f], device) for f in MapState._fields})


def track_carry_from_numpy(d, device=None) -> TrackCarry:
    d = _as_dict(d)
    vals = {f: _to_tensor(d[f], device) for f in TrackCarry._fields if f != "m"}
    return TrackCarry(m=map_state_from_numpy(d["m"], device), **vals)


def to_numpy(x):
    """Port NamedTuple (MapState, TrackCarry, Frame, ...) -> dict of numpy
    arrays, nested NamedTuples as nested dicts. ``desc`` fields (int32
    words) come back as uint32, the reference's dtype."""
    out = {}
    for name, v in x._asdict().items():
        if hasattr(v, "_asdict"):
            out[name] = to_numpy(v)
            continue
        a = v.detach().cpu().numpy()
        if name.endswith("desc") and a.dtype == np.int32:
            a = a.view(np.uint32)
        out[name] = a
    return out
