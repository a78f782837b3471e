"""A launch replayed as one CUDA graph: the sorted sequential loop on a
cluster scene (`engine.render_sum_wavefront`).

That loop issues about 11,000 small device operations a 1920x1088 frame at
4 samples. Run eagerly, the host's enqueue outlasts the device's work, so
the frame is paced by the host and its time swings with the host's load.
The loop makes no host-device sync and its work is fixed by the launch's
shape, so it is captured once per scene and launch shape and replayed: one
host call a launch, the same kernels on the same arguments, bit-equal.

A key's first launch runs eagerly, with torch's sync debug mode at "warn".
If it synced (a scene with alpha cutouts, ORT_QWALK=1, a table built at
first use), the next launch probes again, and after PROBES launches that
synced the key stays eager. The launch after a clean probe is captured and
replayed; later ones replay. Before a replay the camera block and
`subframe` are copied into the graph's own input tensors; the outputs are
copied out, so a later replay never overwrites a sum already returned. The
counters the captured launch bumped on the host (`telemetry.COUNTERS`) are
added again at each later replay, so counts read as the eager loop's;
spans record the capture's host pass only. A scene keeps its graphs
(`DeviceScene.launch_graphs`, at most MAX_LAUNCH_GRAPHS keys, the oldest
dropped with its memory pool). ORT_LAUNCH_GRAPH=0, read at call time,
keeps every launch eager. Counter family "engine.graphs": launches
captured, and launches replayed after their capture.
"""
from __future__ import annotations

import os
import warnings

import torch

from .. import telemetry

# Graphs a scene keeps; each holds one launch's device memory (a 1080p
# frame of the sequential loop: about 1.3 GB).
MAX_LAUNCH_GRAPHS = 2
# Eager launches of a key that synced before it stays eager.
PROBES = 2

GRAPHS = telemetry.counters("engine.graphs", ("captured", "replayed"))

# torch's sync debug warning (c10/cuda/CUDAFunctions.cpp)
_SYNC_WARNING = "called a synchronizing CUDA operation"
_SEEN = object()    # a key whose last eager launch made no sync
_EAGER = object()   # a key whose launches sync: never captured


class LaunchGraph:
    """A captured launch: the graph, its input and output tensors, and the
    counts its host pass added."""

    def __init__(self, graph, cam, subframe, outputs, counts):
        self.graph, self.cam, self.subframe = graph, cam, subframe
        self.outputs, self.counts = outputs, counts


def usable(scene, cam_params, subframe) -> bool:
    """Whether a launch can replay: a CUDA scene, a camera block and a
    `subframe` of tensors on the card, no capture under way, and
    ORT_LAUNCH_GRAPH not set to anything but 1."""
    return (os.environ.get("ORT_LAUNCH_GRAPH", "1") == "1"
            and scene.device.type == "cuda"
            and isinstance(subframe, torch.Tensor) and subframe.is_cuda
            and all(isinstance(v, torch.Tensor) and v.is_cuda
                    for v in cam_params.values())
            and not torch.cuda.is_current_stream_capturing())


def _snapshot() -> dict:
    return {f: dict(d) for f, d in telemetry.COUNTERS.items()}


def _added(before: dict) -> list:
    return [(f, k, v - before.get(f, {}).get(k, 0))
            for f, d in telemetry.COUNTERS.items() for k, v in d.items()
            if v != before.get(f, {}).get(k, 0)]


def _probe(fn, cam_params, subframe):
    """An eager launch under sync debug "warn" → (fn's tensors, whether it
    synced). A mode already set is kept ("error" raises at the sync); other
    warnings pass on."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if mode == 0:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(cam_params, subframe)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    synced = False
    for w in caught:
        if _SYNC_WARNING in str(w.message):
            synced = True
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    return out, synced


def _capture(fn, cam_params, subframe) -> LaunchGraph:
    cam = {k: v.clone() for k, v in cam_params.items()}
    sub = subframe.clone()
    graph = torch.cuda.CUDAGraph()
    before = _snapshot()
    with torch.cuda.graph(graph):
        outputs = fn(cam, sub)
    counts = _added(before)
    GRAPHS["captured"] += 1
    return LaunchGraph(graph, cam, sub, outputs, counts)


def run(scene, key, fn, cam_params, subframe):
    """`fn(cam_params, subframe)`, a launch whose work is fixed by `key`:
    eager while its launches sync, captured after one that made none,
    replayed after → fn's tensors (copies from a graph)."""
    graphs = scene.launch_graphs
    entry = graphs.get(key, 0)
    if entry is _EAGER:
        return fn(cam_params, subframe)
    if isinstance(entry, int):          # eager launches so far, each synced
        if key not in graphs and len(graphs) >= MAX_LAUNCH_GRAPHS:
            del graphs[next(iter(graphs))]
        out, synced = _probe(fn, cam_params, subframe)
        graphs[key] = ((_EAGER if entry + 1 >= PROBES else entry + 1)
                       if synced else _SEEN)
        return out
    with torch.cuda.device(subframe.device):
        if entry is _SEEN:
            entry = graphs[key] = _capture(fn, cam_params, subframe)
        else:
            for k, v in entry.cam.items():
                v.copy_(cam_params[k])
            entry.subframe.copy_(subframe)
            for f, k, v in entry.counts:
                telemetry.COUNTERS[f][k] += v
            GRAPHS["replayed"] += 1
        entry.graph.replay()
        return tuple(t.clone() for t in entry.outputs)
