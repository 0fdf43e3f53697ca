"""L7 device: 1 - device busy / wall over the traced segment. The profiler
slows the host, so this over-states the idle share of an untraced run."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
