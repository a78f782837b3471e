"""The lock-step wavefront engine and the fused path-trace kernel (kernel 3)."""
