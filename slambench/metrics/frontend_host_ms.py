"""L1 frontend: host ms per frame in the program's ``frontend`` span (the
body of ``tracking.build_frame``: the ORB extractions and the stereo search)
over the window; None where the program has no such span."""


def read(ctx):
    if "frontend" not in ctx["timers"] or not ctx["frames"]:
        return None
    return 1e3 * ctx["timers"]["frontend"][0] / ctx["frames"]
