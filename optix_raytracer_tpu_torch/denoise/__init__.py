"""The denoiser backends: the kernel-prediction CNN (`kpcnn`), the
à-trous filter (`atrous`) and block-matching optical flow (`flow`)."""
from . import atrous, flow, kpcnn  # noqa: F401
