"""End to end: frames whose records reached the host inside the window,
over the window's seconds (host clock, the card synchronised at both
ends)."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"]
