"""CUDA kernels: device time per traced launch of the exact cluster cull
(kernel 4, the `__global__` `cull_exact_kernel` of csrc/clusters.cu),
matched by name in the trace; None where no launch ran it."""
from benchmark import trace


def read(ctx):
    ms = [e - s for name, s, e in ctx["trace"]["lib"]
          if trace.kernel_base(name) == "cull_exact_kernel"]
    if not ctx["launches"] or not ms:
        return None
    return sum(ms) * 1e-3 / ctx["launches"]
