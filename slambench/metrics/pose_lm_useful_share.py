"""L2 tracking, the pose solver: the share of the LM iterations launched in
the window that did work, 1 - idle / launched, from the program's counters
``tracking.pose_lm_iters`` (launched) and ``tracking.pose_lm_idle_iters``
(launched after their round had converged); None where the program has no
such counters."""


def read(ctx):
    t = ctx["timers"]
    if "tracking.pose_lm_iters" not in t or \
            "tracking.pose_lm_idle_iters" not in t:
        return None
    launched = t["tracking.pose_lm_iters"][1]
    if launched <= 0:
        return None
    return 1.0 - t["tracking.pose_lm_idle_iters"][1] / launched
