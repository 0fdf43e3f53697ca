"""L2 tracking, the pose solver: host ms per frame in the program's
``tracking.pose_solve`` span (tracking's two pose solves) over the window;
None where the program has no such span."""


def read(ctx):
    if "tracking.pose_solve" not in ctx["timers"] or not ctx["frames"]:
        return None
    return 1e3 * ctx["timers"]["tracking.pose_solve"][0] / ctx["frames"]
