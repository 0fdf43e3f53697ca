"""The one general traffic generator: it reads a traffic file
(``traffic/<name>.json``) and turns it into the hand-ins of a run.

A traffic file names a trajectory of the harness's scene and how many of its
frames a session plays (``trajectory``, ``trajectory_frames``, ``frames``),
the order in which they are played (``order``: ``sessions`` plays frames 0,
1, ..., ``frames`` - 1, resets the system and starts again; ``triangle``
plays 0 up to ``frames`` - 1, back down to 0 and up again, with no end and
no reset), how many frames go into one call (``hand_in``: 1 is
``track_rgbd`` for an RGB-D system, more is ``track_chunk``), the frames
set-up plays (``warm_frames``) and whether set-up ends in a reset
(``reset_after_warm``), and how many frames a traced run profiles after its
window (``trace_frames``). The run's seed makes the room. Frames go in
closed loop: the next call is made when the previous one has returned.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple

KEYS = ("trajectory", "trajectory_frames", "frames", "order", "hand_in",
        "warm_frames", "reset_after_warm", "trace_frames")
ORDERS = ("sessions", "triangle")


class HandIn(NamedTuple):
    """One call: the session's positions it carries (the system's own
    frame numbers within the session) and the image index of each; with
    ``reset_before`` the harness resets the system first."""
    positions: List[int]
    images: List[int]
    reset_before: bool


def validate(traffic: dict) -> dict:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    if traffic["order"] not in ORDERS:
        raise ValueError(f"order {traffic['order']!r} is not one of {ORDERS}")
    if not 1 <= traffic["frames"] <= traffic["trajectory_frames"]:
        raise ValueError("frames must lie in 1..trajectory_frames")
    if traffic["hand_in"] < 1 or traffic["warm_frames"] < 1:
        raise ValueError("hand_in and warm_frames must be positive")
    return traffic


def image_of(traffic: dict, position: int) -> int:
    """The image a session shows at its ``position``-th frame."""
    n = traffic["frames"]
    if traffic["order"] == "sessions" or n == 1:
        return position % n
    period = 2 * (n - 1)
    r = position % period
    return r if r < n else period - r


def hand_ins(traffic: dict) -> Iterator[HandIn]:
    """The calls of a stream that starts a session, without end. In
    ``sessions`` order a call never spans two sessions, and the call that
    opens a new session carries ``reset_before``."""
    step = traffic["hand_in"]
    n = traffic["frames"]
    pos = 0
    reset = False
    while True:
        if traffic["order"] == "sessions":
            if pos == n:
                pos, reset = 0, True
            take = min(step, n - pos)
        else:
            take = step
        positions = list(range(pos, pos + take))
        yield HandIn(positions, [image_of(traffic, p) for p in positions],
                     reset)
        pos += take
        reset = False
