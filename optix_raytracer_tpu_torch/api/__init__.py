"""The OptiX-shaped API surface; so far the denoiser
(`optixDenoiserCreate/Setup/Invoke`, api/__init__.py:22).
"""
from .denoiser import AlphaMode, Denoiser, ModelKind  # noqa: F401
