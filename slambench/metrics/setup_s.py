"""End to end: seconds from the process's start to the window's opening:
imports, the scene rendered on the card, the vocabulary loaded, B1 built
on a checkout's first run, and the warm-up frames."""


def read(ctx):
    return ctx["setup_s"]
