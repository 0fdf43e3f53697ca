"""The traffic generator's frame orders."""

import itertools

import pytest

from slambench import stream

LIVE = dict(trajectory="loop", trajectory_frames=224, frames=5,
            order="sessions", hand_in=1, warm_frames=2,
            reset_after_warm=True, trace_frames=2)
SWEEP = dict(LIVE, trajectory="orbit", trajectory_frames=64, order="triangle",
             hand_in=4, reset_after_warm=False)


def test_triangle_wave():
    t = dict(SWEEP, frames=4)
    assert [stream.image_of(t, p) for p in range(14)] == \
        [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1, 0, 1]


def test_sweep_hand_ins_run_on_without_reset():
    t = dict(SWEEP, frames=4)
    calls = list(itertools.islice(stream.hand_ins(t), 3))
    assert [c.positions for c in calls] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                           [8, 9, 10, 11]]
    assert [c.images for c in calls] == [[0, 1, 2, 3], [2, 1, 0, 1],
                                        [2, 3, 2, 1]]
    assert not any(c.reset_before for c in calls)


def test_sessions_reset_and_replay():
    calls = list(itertools.islice(stream.hand_ins(LIVE), 12))
    assert [c.images[0] for c in calls] == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1]
    assert [c.reset_before for c in calls] == \
        [False] * 5 + [True] + [False] * 4 + [True, False]
    assert [c.positions[0] for c in calls] == [0, 1, 2, 3, 4] * 2 + [0, 1]


def test_session_chunks_stop_at_the_session_end():
    t = dict(LIVE, hand_in=2)
    calls = list(itertools.islice(stream.hand_ins(t), 4))
    assert [c.images for c in calls] == [[0, 1], [2, 3], [4], [0, 1]]
    assert [c.reset_before for c in calls] == [False, False, False, True]


@pytest.mark.parametrize("bad", [dict(order="random"), dict(frames=0),
                                 dict(frames=300), dict(hand_in=0)])
def test_validate_rejects(bad):
    with pytest.raises(ValueError):
        stream.validate(dict(LIVE, **bad))
    t = dict(LIVE)
    del t["frames"]
    with pytest.raises(ValueError):
        stream.validate(t)
