"""The port's own spans (`optix_raytracer_tpu_torch/telemetry.py`) laid over
the device trace of a `--trace 1` run: which code the host was in when the
device idled, when it blocked on a sync, and when it started each device
activity; and the per-layer quantities read from that.

Clocks. A span is stamped on `time.perf_counter_ns`; the profiler stamps its
events on CLOCK_REALTIME (`time.time_ns`). `telemetry.clock_offset_ns()`,
read when the profiler starts and again when it stops, maps one onto the
other (linear in between): every interval below is in perf_counter
nanoseconds. `containment` proves the mapping on a run: the share of the
fused kernel's `cudaLaunchKernel` calls that fall inside a `kernels.launch`
span. The device activities' stamps are the GPU's, converted by CUPTI: on
the H100 they drift from the runtime calls' by up to 355 us a second (seen),
at a rate and from an offset that differ from process to process.
`align_device` fits that lead as a line through the band that causality
leaves it (`lead_constraints`: no activity starts before its launching
call, no sync returns before the work ahead of it ends) and takes it out;
`causal_share` says how many of those constraints the stamps keep.

Attribution. A device activity belongs to the innermost span open when its
launching runtime call started (matched by correlation id); an idle gap of
the device to the innermost span open at the gap's start; a host-blocking
runtime call (SYNCS) to the span it started in. "Innermost" means the
span's own time, its interval less its child spans'.

`ctx_program(...)` makes the dict the quantities read (`ctx["program"]` of
a reader's context); each quantity returns None where the dict or what it
reads is missing. Until `harness.py` turns the spans on and hands them over
(PERF.md, Open questions), `run` drives `harness.run` with them:

    python3 -m benchmark.spans --workload cornell-interactive --seed 7 \\
        --seconds 30

prints the per-span table to stderr and, as its last line, the harness's
result with these quantities added under `program`.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

from . import trace as trace_mod

ROOT_SPAN = "engine.render_accumulate"
LAUNCH_SPAN = "kernels.launch"
APP_SPANS = ("camera.params", "film.reset")
SETUP_SPANS = ("kernels.build", "kernels.load", "scene.upload",
               "scene.fused_tables")
# Runtime calls that hold the host until the device has caught up.
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
                   "cudaMemcpy3D"})
FUSED_KERNEL = "pt_fused_kernel"
# Bins of the device clock's fit (align_device): 50 ms holds a few launches
# of every cell; a bin's band is read at its middle, so the drift within it
# (18 us at the 355 us a second seen) does not bias the fit.
LEAD_BIN_NS = 50_000_000


class Event(NamedTuple):
    """A runtime call or a device activity on the span clock (ns)."""
    name: str
    start: int
    end: int
    corr: int


def _spans_in(spans, lo, hi):
    return [s for s in spans if s.end >= 0 and lo <= s.start and s.end <= hi]


def self_segments(spans) -> list:
    """[(start, end, span)], sorted and disjoint: each instant of a closed
    span's interval that none of its children covers."""
    spans = [s for s in spans if s.end >= 0]
    children = defaultdict(list)
    for s in spans:
        children[s.parent].append(s)
    segs = []
    for s in spans:
        t = s.start
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start):
            if c.start > t:
                segs.append((t, c.start, s))
            t = max(t, c.end)
        if s.end > t:
            segs.append((t, s.end, s))
    segs.sort(key=lambda g: g[0])
    return segs


def innermost(segs, starts, t):
    """The span whose own time holds instant t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segs[i][0] <= t < segs[i][1]:
        return segs[i][2]
    return None


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _idle(device, lo, hi) -> list:
    """The gaps of the union of the device's activities within [lo, hi)."""
    _, gaps = trace_mod._union([(e.start, e.end) for e in device], lo, hi)
    return gaps


def _top_level(spans) -> list:
    return sorted((s.start, s.end) for s in spans
                  if s.end >= 0 and s.parent == -1)


def kineto_events(prof, offset_at) -> tuple:
    """A stopped profiler's events → (runtime calls, device activities),
    each a list of Event on the span clock; offset_at(t_real) gives the
    real-time clock less the span clock at t_real."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    runtime, device = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        off = offset_at(s)
        ev = Event(e.name(), s - off, t - off, e.correlation_id())
        (device if e.device_type() == cuda else runtime).append(ev)
    return runtime, device


def ctx_program(spans, setup, window, runtime=(), device=()) -> dict:
    """What the quantities read: the traced window's spans, the set-up
    spans, the window (lo, hi) and its runtime calls and device
    activities, all on the span clock."""
    lo, hi = window
    return dict(spans=_spans_in(spans, lo, hi), setup=list(setup),
                window=(lo, hi), runtime=list(runtime), device=list(device))


def _launches(p) -> list:
    return [s for s in p["spans"] if s.name == ROOT_SPAN]


def app_host_ms_per_frame(ctx):
    """Median over the traced frames of the frame's `camera.params` and
    `film.reset` span time (ms); None where no frame has one."""
    p = ctx.get("program")
    if not p:
        return None
    per = defaultdict(int)
    for s in p["spans"]:
        if s.name in APP_SPANS:
            per[s.launch] += s.duration
    frames = [s.launch for s in _launches(p)]
    if not per or not frames:
        return None
    return statistics.median(per[k] for k in frames) * 1e-6


def engine_self_ms_per_launch(ctx):
    """Median over the traced launches of `engine.render_accumulate`'s
    duration less its `kernels.launch` descendants' (ms)."""
    p = ctx.get("program")
    if not p or not _launches(p):
        return None
    by_id = {s.id: s for s in p["spans"]}
    kernel_ns = defaultdict(int)
    for s in p["spans"]:
        if s.name != LAUNCH_SPAN:
            continue
        a = by_id.get(s.parent)
        while a is not None and a.name != ROOT_SPAN:
            a = by_id.get(a.parent)
        if a is not None:
            kernel_ns[a.id] += s.duration
    return statistics.median(s.duration - kernel_ns[s.id]
                             for s in _launches(p)) * 1e-6


def host_syncs_per_launch(ctx):
    """Host-blocking runtime calls that started inside a program span, per
    traced launch; None without device activities."""
    p = ctx.get("program")
    if not p or not p["device"] or not _launches(p):
        return None
    tops = _top_level(p["spans"])
    starts = [a for a, _ in tops]
    n = 0
    for e in p["runtime"]:
        if e.name in SYNCS:
            i = bisect.bisect_right(starts, e.start) - 1
            n += i >= 0 and e.start < tops[i][1]
    return n / len(_launches(p))


def device_idle_program_pct(ctx):
    """Share of the traced window (%) in which the device ran nothing while
    the host was inside a program span."""
    p = ctx.get("program")
    if not p or not p["device"]:
        return None
    lo, hi = p["window"]
    return 100.0 * _overlap(_idle(p["device"], lo, hi),
                            _top_level(p["spans"])) / (hi - lo)


def device_idle_pct(p) -> float:
    """The whole idle share of the window (%), from the same intervals."""
    lo, hi = p["window"]
    return 100.0 * sum(b - a for a, b in _idle(p["device"], lo, hi)) / (
        hi - lo)


def program_setup_s(ctx):
    """Seconds in the set-up spans before the first timed launch, each
    counted once (a set-up span inside another is not added again)."""
    p = ctx.get("program")
    if not p:
        return None
    by_id = {s.id: s for s in p["setup"]}

    def nested(s):
        a = by_id.get(s.parent)
        while a is not None:
            if a.name in SETUP_SPANS:
                return True
            a = by_id.get(a.parent)
        return False

    tops = [s for s in p["setup"] if s.name in SETUP_SPANS and s.end >= 0
            and not nested(s)]
    return sum(s.duration for s in tops) * 1e-9 if tops else None


# name → (reader, unit), in the order of the per-layer table of PERF.md §3
QUANTITIES = {
    "app_host_ms_per_frame": (app_host_ms_per_frame, "ms"),
    "engine_self_ms_per_launch": (engine_self_ms_per_launch, "ms"),
    "host_syncs_per_launch": (host_syncs_per_launch, "syncs"),
    "device_idle_program_pct": (device_idle_program_pct, "%"),
    "program_setup_s": (program_setup_s, "s"),
}


def containment(p, kernel=FUSED_KERNEL):
    """Share of the `cudaLaunchKernel` calls whose device activity is
    `kernel` that lie wholly inside a `kernels.launch` span, and their
    number; (None, 0) where there are none."""
    names = {e.corr for e in p["device"]
             if trace_mod.kernel_base(e.name) == kernel}
    calls = [e for e in p["runtime"]
             if e.name == "cudaLaunchKernel" and e.corr in names]
    if not calls:
        return None, 0
    spans = sorted((s.start, s.end) for s in p["spans"]
                   if s.name == LAUNCH_SPAN)
    starts = [a for a, _ in spans]
    inside = 0
    for e in calls:
        i = bisect.bisect_right(starts, e.start) - 1
        inside += i >= 0 and e.end <= spans[i][1]
    return inside / len(calls), len(calls)


def lead_constraints(p) -> tuple:
    """What causality says of the device stamps' lead over the runtime
    calls' (ns), each at the time of the call it comes from: no activity
    starts before its launching call (upper: [(t, start - call start)]),
    no host sync returns before the work launched ahead of it ends (lower:
    [(t, that work's last end - sync end)])."""
    call = {e.corr: e for e in p["runtime"] if e.corr}
    launched = sorted((call[d.corr].start, d.end, d.start - call[d.corr].start)
                      for d in p["device"] if d.corr in call)
    upper = [(t, v) for t, _, v in launched]
    lower, i, last_end = [], 0, None
    for e in sorted((e for e in p["runtime"] if e.name in SYNCS),
                    key=lambda e: e.start):
        while i < len(launched) and launched[i][0] < e.start:
            last_end = max(last_end or launched[i][1], launched[i][1])
            i += 1
        if last_end is not None:
            lower.append((e.start, last_end - e.end))
    return upper, lower


def device_lead(p, bin_ns=LEAD_BIN_NS):
    """The device stamps' lead as a line in time, (t0, lead at t0, slope):
    the window cut into bins of bin_ns, each giving the middle of the band
    its constraints leave (lowest upper, highest lower), and the
    Theil-Sen line through those middles; None without a bin that has
    both kinds of constraint."""
    upper, lower = lead_constraints(p)
    up, lo = {}, {}
    for t, v in upper:
        k = t // bin_ns
        up[k] = min(up.get(k, v), v)
    for t, v in lower:
        k = t // bin_ns
        lo[k] = max(lo.get(k, v), v)
    mids = sorted(((k + 0.5) * bin_ns, (up[k] + lo[k]) / 2)
                  for k in up.keys() & lo.keys())
    if not mids:
        return None
    slopes = [(b[1] - a[1]) / (b[0] - a[0])
              for n, a in enumerate(mids) for b in mids[n + 1:]]
    slope = statistics.median(slopes) if slopes else 0.0
    t0 = mids[0][0]
    return t0, statistics.median(v - slope * (t - t0) for t, v in mids), slope


def align_device(p, bin_ns=LEAD_BIN_NS):
    """The window with each device activity moved back by device_lead at
    its start → (window, the line or None, unmoved)."""
    fit = device_lead(p, bin_ns)
    if fit is None:
        return p, None
    t0, a, b = fit
    dev = []
    for e in p["device"]:
        lead = round(a + b * (e.start - t0))
        dev.append(e._replace(start=e.start - lead, end=e.end - lead))
    return dict(p, device=dev), fit


def causal_share(p):
    """Share of lead_constraints that the window's stamps keep (1.0: no
    activity starts before its call, no sync returns before its work
    ends); None without constraints."""
    upper, lower = lead_constraints(p)
    n = len(upper) + len(lower)
    if not n:
        return None
    return 1.0 - (sum(v < 0 for _, v in upper)
                  + sum(v > 0 for _, v in lower)) / n


def table(p) -> list:
    """Per span name: dict(name, per_launch (count), self_ms, device_ms
    (device activities it started), idle_ms (device idle in its own time),
    syncs), each per traced launch; the last row, "(no span)", holds what
    falls outside every span."""
    n = max(len(_launches(p)), 1)
    segs = self_segments(p["spans"])
    starts = [g[0] for g in segs]
    lo, hi = p["window"]
    idle = _idle(p["device"], lo, hi)
    rows = defaultdict(lambda: dict(count=0, self_ns=0, device_ns=0,
                                    idle_ns=0, syncs=0))
    for s in p["spans"]:
        rows[s.name]["count"] += 1
    own = defaultdict(list)
    for a, b, s in segs:
        rows[s.name]["self_ns"] += b - a
        own[s.name].append((a, b))
    for name, iv in own.items():
        rows[name]["idle_ns"] = _overlap(idle, iv)
    rows["(no span)"]["idle_ns"] = sum(b - a for a, b in idle) - sum(
        r["idle_ns"] for r in rows.values())
    call = {e.corr: e for e in p["runtime"] if e.corr}
    for d in p["device"]:
        r = call.get(d.corr)
        s = innermost(segs, starts, r.start) if r is not None else None
        rows[s.name if s else "(no span)"]["device_ns"] += d.end - d.start
    for e in p["runtime"]:
        if e.name in SYNCS:
            s = innermost(segs, starts, e.start)
            rows[s.name if s else "(no span)"]["syncs"] += 1
    out = []
    for name, r in sorted(rows.items(), key=lambda kv: kv[0] == "(no span)"):
        out.append(dict(name=name, per_launch=r["count"] / n,
                        self_ms=r["self_ns"] * 1e-6 / n,
                        device_ms=r["device_ns"] * 1e-6 / n,
                        idle_ms=r["idle_ns"] * 1e-6 / n,
                        syncs=r["syncs"] / n))
    return out


def idle_gaps(p, top=10) -> list:
    """The `top` longest idle gaps between the window's first and last
    device activity, [label, seconds]: the innermost span open at the gap's
    start, then the runtime call open there if any ("engine.pack_camera /
    cudaStreamSynchronize"); "host: python" where no span was open."""
    if not p["device"]:
        return []
    lo = min(e.start for e in p["device"])
    hi = max(e.end for e in p["device"])
    segs = self_segments(p["spans"])
    starts = [g[0] for g in segs]
    out = []
    for g0, g1 in sorted(_idle(p["device"], lo, hi),
                         key=lambda g: g[0] - g[1])[:top]:
        s = innermost(segs, starts, g0)
        call = None
        for e in p["runtime"]:
            if e.start <= g0 < e.end and (call is None
                                          or e.start >= call.start):
                call = e
        if s is None:
            label = call.name if call else "host: python"
        else:
            label = s.name + (f" / {call.name}" if call else "")
        out.append([label, (g1 - g0) * 1e-9])
    return out


def print_table(rows, log=sys.stderr):
    print(f"{'span':<34}{'a launch':>9}{'self ms':>9}{'device ms':>10}"
          f"{'idle ms':>9}{'syncs':>7}", file=log)
    for r in rows:
        print(f"{r['name']:<34}{r['per_launch']:>9.3f}{r['self_ms']:>9.4f}"
              f"{r['device_ms']:>10.4f}{r['idle_ms']:>9.4f}"
              f"{r['syncs']:>7.3f}", file=log)


def run(root, workload, seed, seconds, device=None, log=sys.stderr):
    """`harness.run(..., trace=True)` with the port's spans on from here
    through set-up, off for the untraced launches, and on again while the
    profiler records → (exit code, result dict or None), the result
    holding `program`: the QUANTITIES, `containment`, the device clock's
    fitted lead and the causal share before and after it is taken out, the
    registry's counters (those not 0: the launches of each kernel, the
    libraries compiled), `idle_gaps` named by span and the per-span
    `table`."""
    from torch import profiler as tp

    from optix_raytracer_tpu_torch import telemetry
    from optix_raytracer_tpu_torch.core.film import Film

    from . import harness

    state = {}
    real_profile, real_create = tp.profile, Film.__dict__["create"]
    real_reduce = harness.trace_mod.reduce
    films = []

    class Profile(real_profile):
        def start(self):
            super().start()
            state["o0"] = telemetry.clock_offset_ns()
            state["w0"] = time.perf_counter_ns()
            telemetry.drain()
            telemetry.enable()

        def stop(self):
            telemetry.disable()
            state["w1"] = time.perf_counter_ns()
            state["o1"] = telemetry.clock_offset_ns()
            state["spans"] = telemetry.drain()
            super().stop()
            state["prof"] = self

    def create(cls, *a, **k):
        films.append(1)
        if len(films) == 2:          # the window's film: set-up is over
            telemetry.disable()
            state["setup"] = telemetry.drain()
        return real_create.__func__(cls, *a, **k)

    def reduce(events, lib_names, window_s):
        state["window_s"] = window_s
        return real_reduce(events, lib_names, window_s)

    telemetry.reset_spans()
    telemetry.enable()
    tp.profile, Film.create = Profile, classmethod(create)
    harness.trace_mod.reduce = reduce
    try:
        code, result = harness.run(root, workload, seed, seconds, True,
                                   device=device, log=log)
    finally:
        telemetry.disable()
        tp.profile, Film.create = real_profile, real_create
        harness.trace_mod.reduce = real_reduce
    if result is None:
        return code, None
    w0, w1, o0, o1 = state["w0"], state["w1"], state["o0"], state["o1"]
    real0, real1 = w0 + o0, w1 + o1

    def offset_at(t_real):
        if real1 == real0:
            return o0
        return round(o0 + (o1 - o0) * (t_real - real0) / (real1 - real0))

    runtime, dev = kineto_events(state.pop("prof"), offset_at)
    p = ctx_program(state["spans"], state["setup"],
                    (w0, w0 + round(state["window_s"] * 1e9)), runtime, dev)
    kept = causal_share(p)
    p, fit = align_device(p)
    ctx = {"program": p}
    out = {}
    for name, (read, unit) in QUANTITIES.items():
        value = read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    share, calls = containment(p)
    rows = table(p)
    counts = {f: {k: v for k, v in d.items() if v}
              for f, d in telemetry.COUNTERS.items()}
    extra = dict(metrics=out, containment=share, fused_launch_calls=calls,
                 counters=counts,
                 device_lead=fit, causal_share=[kept, causal_share(p)],
                 launches=len(_launches(p)), idle_gaps=idle_gaps(p),
                 table=rows)
    if dev:
        extra["device_idle_pct"] = device_idle_pct(p)
    result["program"] = extra
    print_table(rows, log)
    print("spans: " + ", ".join(f"{k} {v['value']:.6g} {v['unit']}"
                                for k, v in out.items())
          + f"; fused kernel launches inside kernels.launch: {share!r} of "
          f"{calls}; device stamps' lead (t0, ns, ns/ns) {fit}, causal "
          f"share {kept!r} before and {causal_share(p)!r} after; "
          f"counters {counts}", file=log)
    return code, result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    code, result = run(root, args.workload, args.seed, args.seconds)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
