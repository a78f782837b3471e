"""CUDA kernels: device time per launch of the port's library kernels (the
`__global__` functions of its csrc/), matched by name in the trace."""


def read(ctx):
    tr = ctx["trace"]
    if not ctx["launches"] or not tr["lib"]:
        return None
    return sum(e - s for _, s, e in tr["lib"]) * 1e-3 / ctx["launches"]
