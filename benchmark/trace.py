"""Reduce a device-only `torch.profiler` trace of the window's last launches
to what the per-layer readers take: the device's activities (kernels,
copies, sets), the device's busy time as the union of their intervals, and
the breakdown of the result line.

Times are microseconds on the profiler's clock. The trace records no host
ops, only the CUDA runtime's calls beside the device's work; an idle gap is
named by the runtime call open at its start, or "host: python" where none
is. The traced window's length comes from the host's clock: from the
profiler's start, with the device idle and synchronized, to the sync after
the last traced launch.
"""
from __future__ import annotations

import re
from pathlib import Path

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")



def library_kernels(csrc: Path) -> set:
    """The `__global__` kernels of the port's CUDA sources."""
    names = set()
    for src in sorted(Path(csrc).glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def kernel_base(name: str) -> str:
    """`void ns::(anonymous namespace)::pt_fused_kernel<0, false>(float
    const*, ...)` → `pt_fused_kernel`."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    return re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1].strip()


def short_name(name: str, limit: int = 200) -> str:
    """A device activity's name without its argument list, at most `limit`
    characters."""
    head = name.replace("(anonymous namespace)::", "")
    return re.split(r"\((?!lambda)", head, maxsplit=1)[0].strip()[:limit]


def _union(intervals, lo, hi):
    """Length of the union of [s, e) clipped to [lo, hi), and its gaps."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def reduce(events, lib_names: set, window_s: float) -> dict:
    """events: the profiler's `events()`; window_s: the traced window's
    length on the host's clock → dict(device: [(name, start, end)], lib:
    those of the port's library, window_s, busy_us, device_ops,
    idle_gaps)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        (device if e.device_type == cuda else host).append((e.name, s, t))
    if not device:
        return dict(device=[], window_s=window_s, busy_us=0.0, device_ops=[],
                    idle_gaps=[], lib=[])
    lo = min(s for _, s, _ in device)
    hi = max(t for _, _, t in device)
    busy, gaps = _union([(s, t) for _, s, t in device], lo, hi)

    by_name = {}
    for name, s, t in device:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for g0, g1 in longest:
        # what the host was doing: the innermost runtime call open at the gap
        inner = None
        for name, s, t in host:
            if s <= g0 < t and (inner is None or s >= inner[1]):
                inner = (name, s)
        idle.append([inner[0] if inner else "host: python", (g1 - g0) * 1e-6])
    return dict(device=device, window_s=window_s, busy_us=busy,
                device_ops=[[short_name(n), v * 1e-6] for n, v in top],
                idle_gaps=idle,
                lib=[d for d in device if kernel_base(d[0]) in lib_names])
