"""Triangle geometry, brute-force intersection (kernels 1 and 2), the LBVH
and its walk, and the cluster, queue, prim, curve, motion, micromap,
instance and volume layers (counterpart of `accel/__init__.py`)."""
from . import geometry, bruteforce, pallas_bf, morton, lbvh, traverse  # noqa: F401
