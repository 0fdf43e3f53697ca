"""L2 tracking: host ms per frame in the program's ``tracking.fetch`` span
(the records' one fetch, where the host is blocked until the card has
finished the frames) over the window; None where the program has no such
span."""


def read(ctx):
    if "tracking.fetch" not in ctx["timers"] or not ctx["frames"]:
        return None
    return 1e3 * ctx["timers"]["tracking.fetch"][0] / ctx["frames"]
