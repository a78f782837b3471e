"""Device: the share of the traced window in which no device activity ran,
1 - (union of the activity intervals) / (the window), from one device-only
trace and the window's length on the host's clock."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["device"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] * 1e-6 / tr["window_s"])
