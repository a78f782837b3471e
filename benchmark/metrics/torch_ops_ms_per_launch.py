"""Engine paths: device time per launch of every device activity that is
not a kernel of the port's CUDA library (eager torch ops, copies, sets)."""


def read(ctx):
    tr = ctx["trace"]
    if not ctx["launches"]:
        return None
    total = sum(e - s for _, s, e in tr["device"])
    lib = sum(e - s for _, s, e in tr["lib"])
    if not tr["device"]:
        return None
    return (total - lib) * 1e-3 / ctx["launches"]
