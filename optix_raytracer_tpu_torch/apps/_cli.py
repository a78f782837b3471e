"""Shared CLI helpers of the port's apps (counterpart of `apps/_cli.py`)."""
from __future__ import annotations


def parse_dim(s: str):
    """'WxH' → (w, h); a malformed value exits with a usage message."""
    try:
        w_str, h_str = s.lower().split("x")
        w, h = int(w_str), int(h_str)
        if w <= 0 or h <= 0:
            raise ValueError
        return w, h
    except (ValueError, AttributeError):
        raise SystemExit(
            f"error: --dim expects WIDTHxHEIGHT (e.g. 768x768), got {s!r}")
