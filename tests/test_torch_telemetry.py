"""The port's spans and counters (`optix_raytracer_tpu_torch/telemetry.py`)
on the CPU: off by default and recording nothing; on, a Cornell launch's
span tree and launch numbers; the self-time arithmetic the benchmark
applies to them (`benchmark/spans.py`); the counter
families (`kernels.LAUNCHES`, `qwalk.STATS`, ...) with their keys and
counts; and a span's stamps mapped onto the profiler's clock around the
event of the op inside it. The card's side (a `kernels.launch` span holds
the fused kernel's `cudaLaunchKernel`) is in test_torch_gpu.py."""
import time

import pytest
import torch

from optix_raytracer_tpu_torch import kernels, telemetry
from optix_raytracer_tpu_torch.accel import qwalk
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                     cornell_camera)
from optix_raytracer_tpu_torch.wavefront import (engine, intersect,
                                                 launch_graph, pallas_pt)

W = H = 8


@pytest.fixture
def spans():
    """Spans on, from an empty buffer and launch 0; off again after."""
    telemetry.reset_spans()
    telemetry.enable()
    try:
        yield telemetry
    finally:
        telemetry.disable()
        telemetry.reset_spans()


def launch(scene, cam, film, impl="auto"):
    return engine.render_accumulate(scene, cam, film, W, H,
                                    samples_per_launch=1, max_depth=2,
                                    impl=impl)[0]


def test_spans_are_off_by_default_and_record_nothing(monkeypatch):
    assert telemetry.ENABLED is False
    telemetry.reset_spans()
    scene = cornell_box("cpu")
    cam = cornell_camera(W, H).params("cpu")
    film = launch(scene, cam, Film.create(H, W, "cpu").reset())

    def no_clock():
        raise AssertionError("a span site read the clock while off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert telemetry.span("a") is telemetry.span("b", "tag")
    assert telemetry.launch("c") is telemetry.span("a")
    with telemetry.span("a"), telemetry.launch("c"):
        pass
    monkeypatch.undo()
    assert film.subframe.item() == 1
    assert telemetry.drain() == []


def test_cornell_launch_span_tree(spans):
    """Set-up, then per launch the camera and the film reset, which take
    the next launch's number, and the launch's tree: the CPU runs the
    wavefront under `auto`, and the fused path's plain version under
    `fused`."""
    scene = cornell_box("cpu")
    cam = cornell_camera(W, H).params("cpu")
    film = Film.create(H, W, "cpu")
    for k, impl in enumerate(("auto", "auto", "fused")):
        if k:
            cam = cornell_camera(W, H).params("cpu")
        film = launch(scene, cam, film.reset(), impl)
    got = spans.drain()
    by_id = {s.id: s for s in got}

    def path(s):
        names = [s.name]
        while s.parent != -1:
            s = by_id[s.parent]
            names.append(s.name)
        return "/".join(reversed(names))

    assert [(path(s), s.launch) for s in got] == [
        ("scene.upload", 0),
        ("camera.params", 0),
        ("film.reset", 0),
        ("engine.render_accumulate", 0),
        ("engine.render_accumulate/engine.render_sum_wavefront", 0),
        ("engine.render_accumulate/engine.merge", 0),
        ("camera.params", 1),
        ("film.reset", 1),
        ("engine.render_accumulate", 1),
        ("engine.render_accumulate/engine.render_sum_wavefront", 1),
        ("engine.render_accumulate/engine.merge", 1),
        ("camera.params", 2),
        ("film.reset", 2),
        ("engine.render_accumulate", 2),
        ("engine.render_accumulate/engine.render_sum_fused", 2),
        ("engine.render_accumulate/engine.render_sum_fused/"
         "engine.render_sum_wavefront", 2),
        ("engine.render_accumulate/engine.merge", 2),
    ]
    for s in got:
        assert 0 < s.start <= s.end
        if s.parent != -1:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end
    assert [s.id for s in got] == list(range(len(got)))
    assert spans.drain() == []


def own_time(spans) -> dict:
    """Span id → its own time from the benchmark's span arithmetic
    (benchmark/spans.py: the span's interval less its children's)."""
    from benchmark.spans import self_segments
    out = dict.fromkeys((s.id for s in spans), 0)
    for a, b, s in self_segments(spans):
        out[s.id] += b - a
    return out


def test_self_times():
    S = telemetry.Span
    spans = [S(0, "root", None, 100, 200, -1, 0),
             S(1, "a", None, 110, 130, 0, 0),
             S(2, "b", None, 140, 190, 0, 0),
             S(3, "c", None, 150, 160, 2, 0),
             S(4, "other", None, 300, 305, -1, 1)]
    assert own_time(spans) == {0: 30, 1: 20, 2: 40, 3: 10, 4: 5}


def test_self_times_of_a_recorded_launch(spans):
    scene = cornell_box("cpu")
    film = launch(scene, cornell_camera(W, H).params("cpu"),
                  Film.create(H, W, "cpu"))
    got = spans.drain()
    own = own_time(got)
    for s in got:
        kids = [k for k in got if k.parent == s.id]
        assert own[s.id] == s.duration - sum(k.duration for k in kids)
        assert own[s.id] >= 0
    assert film.subframe.item() == 1


LAUNCH_KEYS = ["bf_closest", "bf_any", *kernels.FUSED_INSTANTIATIONS,
               "cluster_cull_exact", "cluster_closest", "cluster_any",
               "cluster_sc_closest", "cluster_sc_any", "qwalk_oct_cull",
               "qwalk_closest", "qwalk_any", "texfetch", "bvh_walk_closest",
               "bvh_walk_any", "rng_seed", "rng_uniform2"]


@pytest.mark.parametrize("family, counts, keys, reset", [
    ("kernels.launches", kernels.LAUNCHES, LAUNCH_KEYS,
     kernels.reset_launches),
    ("qwalk.queries", qwalk.STATS, ["closest_queue", "closest_overflow",
                                    "any_queue", "any_overflow"],
     qwalk.reset_stats),
    ("intersect.alpha", intersect.ALPHA_STATS, ["loops", "steps"],
     intersect.reset_alpha_stats),
    ("kernels.builds", kernels.BUILDS, ["libraries"], None),
    ("fused.plans", pallas_pt.PLANS, ["built", "reused"], None),
    ("engine.graphs", launch_graph.GRAPHS, ["captured", "replayed"], None),
])
def test_counter_families_keep_their_dicts(family, counts, keys, reset):
    """Each counter dict is its family in the registry, with its keys in
    order; the module's reset zeroes it in place."""
    assert telemetry.COUNTERS[family] is counts
    assert list(counts) == keys
    saved = dict(counts)
    try:
        for i, k in enumerate(keys):
            counts[k] += i + 1
        assert telemetry.counters(family, keys[:1]) is counts
        assert counts[keys[-1]] == saved[keys[-1]] + len(keys)
        (reset or (lambda: telemetry.reset_counters(family)))()
        assert telemetry.COUNTERS[family] is counts
        assert counts == dict.fromkeys(keys, 0)
    finally:
        counts.update(saved)


def test_kernel_launch_counts_and_spans(spans):
    """`kernels.launch(name)` adds one to LAUNCHES[name], on or off, and
    with spans on records a `kernels.launch` span tagged with the name."""
    before = kernels.LAUNCHES["bf_any"]
    spans.disable()
    with kernels.launch("bf_any"):
        pass
    assert spans.drain() == []
    spans.enable()
    with spans.launch("engine.render_accumulate"):
        with kernels.launch("bf_any"):
            pass
    kernels.LAUNCHES["bf_any"] -= 2
    assert kernels.LAUNCHES["bf_any"] == before
    root, k = spans.drain()
    assert (k.name, k.tag, k.parent, k.launch) == ("kernels.launch",
                                                   "bf_any", root.id, 0)
    with spans.span("next"):
        pass
    assert spans.drain()[0].launch == 1


def test_drain_refuses_an_open_span_and_an_overflow(spans, monkeypatch):
    with spans.span("open"):
        with pytest.raises(RuntimeError):
            spans.drain()
    spans.drain()
    monkeypatch.setattr(telemetry, "CAPACITY", 2)
    for _ in range(3):
        with spans.span("s"):
            pass
    with pytest.raises(OverflowError):
        spans.drain()
    assert spans.drain() == []


def test_span_holds_its_op_on_the_profilers_clock(spans):
    """Mapped with clock_offset_ns, the span's interval contains the
    profiler's event of the op run inside it."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones((64, 64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with spans.span("matmul"):
                x = x @ x * 0.01
    offset = telemetry.clock_offset_ns()
    got = spans.drain()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == len(got) == 3
    for s, e in zip(got, ops):
        assert s.start <= e.start_ns() - offset
        assert e.end_ns() - offset <= s.end
