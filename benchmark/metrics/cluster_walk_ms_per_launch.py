"""CUDA kernels: device time per traced launch of the cluster walks
(kernels 5 and 6, the `__global__` `cluster_walk_kernel` of
csrc/clusters.cu, closest-hit and any-hit alike), matched by name in the
trace; None where no launch ran them."""
from benchmark import trace


def read(ctx):
    ms = [e - s for name, s, e in ctx["trace"]["lib"]
          if trace.kernel_base(name) == "cluster_walk_kernel"]
    if not ctx["launches"] or not ms:
        return None
    return sum(ms) * 1e-3 / ctx["launches"]
