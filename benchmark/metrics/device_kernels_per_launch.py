"""Engine paths: device activities (kernels, copies, sets) per launch in the
traced window."""


def read(ctx):
    tr = ctx["trace"]
    if not ctx["launches"] or not tr["device"]:
        return None
    return len(tr["device"]) / ctx["launches"]
