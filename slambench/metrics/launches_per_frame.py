"""L7 device: kernel launch calls of the runtime in the traced segment, per
frame."""


def read(ctx):
    t = ctx["trace"]
    return t["launches"] / t["frames"] if t and t["frames"] else None
