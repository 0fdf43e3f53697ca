"""L4 loop closing and place recognition: host ms per frame in
``System.timers``'s ``loop_closing`` stage over the window."""


def read(ctx):
    total, _ = ctx["timers"].get("loop_closing", (0.0, 0))
    return 1e3 * total / ctx["frames"] if ctx["frames"] else None
