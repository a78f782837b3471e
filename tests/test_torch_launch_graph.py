"""`wavefront/launch_graph.py` on the CPU: when a launch may replay, and the
bookkeeping of `run` (eager while its launches sync, captured after a clean
one, replayed after; inputs copied in, outputs copied out, counters added
again, the oldest graph dropped) with the CUDA graph calls and the sync
debug mode stood in for. The replay itself, bit-equal
to the eager loop, is `tests/test_torch_gpu.py::
test_launch_graph_replays_the_eager_loop`."""
import contextlib
import types
import warnings

import pytest
import torch

from optix_raytracer_tpu_torch import telemetry
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.wavefront import engine, launch_graph


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def sync():
    """What torch does at a sync under sync debug "warn"."""
    if MODE[0] == 1:
        warnings.warn(launch_graph._SYNC_WARNING)


MODE = [0]


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDAGraph, graph, device and the sync debug mode stood in for: the
    capture runs its function once on the CPU; a replay only counts."""
    def set_mode(mode):
        MODE[0] = {"warn": 1, "error": 2}.get(mode, mode)

    MODE[0] = 0
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: MODE[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    counts = telemetry.counters("test.launch_graph", ("calls", "rays"))
    saved = dict(launch_graph.GRAPHS)
    yield counts
    launch_graph.GRAPHS.update(saved)
    del telemetry.COUNTERS["test.launch_graph"]


def test_run_eager_then_captured_then_replayed(fake_cuda):
    counts = fake_cuda
    scene = types.SimpleNamespace(launch_graphs={})
    seen = []

    def fn(cam, sub):
        seen.append((cam, sub))
        counts["calls"] += 1
        counts["rays"] += 10
        return cam["eye"] * 2, sub + 1

    def launch(eye, sub):
        return launch_graph.run(scene, "k", fn,
                                {"eye": torch.tensor([eye, 0.0])},
                                torch.tensor(sub))

    telemetry.reset_counters("engine.graphs")
    a = launch(1.0, 0)                          # eager
    assert scene.launch_graphs["k"] is launch_graph._SEEN
    assert torch.equal(a[0], torch.tensor([2.0, 0.0])) and int(a[1]) == 1
    b = launch(3.0, 4)                          # captured, replayed once
    entry = scene.launch_graphs["k"]
    assert isinstance(entry, launch_graph.LaunchGraph)
    assert entry.graph.replays == 1 and len(seen) == 2
    assert seen[1] == (entry.cam, entry.subframe)        # the graph's inputs
    assert torch.equal(b[0], torch.tensor([6.0, 0.0])) and int(b[1]) == 5
    assert b[0].data_ptr() != entry.outputs[0].data_ptr()
    assert entry.counts == [("test.launch_graph", "calls", 1),
                            ("test.launch_graph", "rays", 10)]
    assert counts == dict(calls=2, rays=20)
    launch(5.0, 8)                              # replayed
    launch(7.0, 12)
    assert len(seen) == 2 and entry.graph.replays == 3
    assert torch.equal(entry.cam["eye"], torch.tensor([7.0, 0.0]))
    assert int(entry.subframe) == 12
    assert counts == dict(calls=4, rays=40)
    assert launch_graph.GRAPHS == dict(captured=1, replayed=2)


def test_run_probes_until_a_launch_makes_no_sync(fake_cuda):
    """A launch that syncs is probed again; one clean probe lets the next
    launch be captured; PROBES launches that synced leave the key eager.
    Other warnings pass on, and the sync debug mode is put back."""
    scene = types.SimpleNamespace(launch_graphs={})
    syncs = [True, False, True, True, True, True]
    calls = []

    def fn(cam, sub):
        calls.append(MODE[0])
        if syncs[len(calls) - 1]:
            sync()
        warnings.warn("kept")
        return (sub + 1,)

    def launch(key):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            launch_graph.run(scene, key, fn, {}, torch.tensor(0))
        assert [str(w.message) for w in caught] == ["kept"]
        assert MODE[0] == 0

    launch("a")                                 # synced
    assert scene.launch_graphs["a"] == 1
    launch("a")                                 # clean
    assert scene.launch_graphs["a"] is launch_graph._SEEN
    launch("a")                                 # captured
    assert isinstance(scene.launch_graphs["a"], launch_graph.LaunchGraph)
    assert calls == [1, 1, 0]
    for _ in range(launch_graph.PROBES):
        launch("b")
    assert scene.launch_graphs["b"] is launch_graph._EAGER
    launch("b")                                 # eager, not probed
    assert calls[3:] == [1] * launch_graph.PROBES + [0]


def test_run_keeps_the_newest_graphs(fake_cuda):
    scene = types.SimpleNamespace(launch_graphs={})
    cap = launch_graph.MAX_LAUNCH_GRAPHS
    for key in range(cap + 2):
        for _ in range(2):
            launch_graph.run(scene, key, lambda cam, sub: (sub + 1,), {},
                             torch.tensor(0))
    assert list(scene.launch_graphs) == list(range(2, cap + 2))


def test_usable_only_on_the_card(monkeypatch):
    """A CPU scene or CPU inputs run eagerly, as does ORT_LAUNCH_GRAPH=0."""
    scene = types.SimpleNamespace(device=torch.device("cpu"))
    cam = {"eye": torch.zeros(3)}
    assert not launch_graph.usable(scene, cam, torch.tensor(0))
    monkeypatch.setenv("ORT_LAUNCH_GRAPH", "0")
    cuda_scene = types.SimpleNamespace(device=torch.device("cuda"))
    assert not launch_graph.usable(cuda_scene, cam, torch.tensor(0))


def test_cpu_cluster_launch_keeps_no_graph():
    """The sequential loop on a CPU cluster scene stays eager: the scene
    keeps no graph and `engine.graphs` does not move."""
    scene = B.spd_tetra_scene("cpu", level=4)
    assert scene.has_clusters
    cam = B.spd_tetra_camera(8, 8).params("cpu")
    before = dict(launch_graph.GRAPHS)
    film = Film.create(8, 8, "cpu")
    for _ in range(3):
        film, _ = engine.render_accumulate(scene, cam, film, 8, 8,
                                           samples_per_launch=1, max_depth=1,
                                           impl="wavefront")
    assert scene.launch_graphs == {} and launch_graph.GRAPHS == before
