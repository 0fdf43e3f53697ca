"""L2 tracking: host ms per frame in the program's ``tracking.search`` span
(tracking's four searches and its frustum check) over the window; None
where the program has no such span."""


def read(ctx):
    if "tracking.search" not in ctx["timers"] or not ctx["frames"]:
        return None
    return 1e3 * ctx["timers"]["tracking.search"][0] / ctx["frames"]
