"""L6 kernel B1: the least time the traced segment's B1 calls could take
(``reference/b1.work``: bytes at 3.35 TB/s or simple operations at 33.5 T/s,
whichever bounds) as a share, in %, of their device time in the profile."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["b1_calls"] or t["b1_device_s"] <= 0:
        return None
    return 100.0 * t["b1_bound_s"] / t["b1_device_s"]
