"""L2 tracking: host ms per frame in ``System.timers``'s ``tracking`` stage
over the window; the stage ends in the records' fetch, so it holds the
card's completion of the frame."""


def read(ctx):
    total, _ = ctx["timers"].get("tracking", (0.0, 0))
    return 1e3 * total / ctx["frames"] if ctx["frames"] else None
