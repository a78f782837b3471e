"""The port's spans laid over a device trace (`benchmark/spans.py`): each
quantity on a made-up window with known spans, device activities, idle
gaps and runtime calls; the clock check; the gap labels; and the span
runner driving the harness on the CPU at tiny sizes, where the quantities
that read spans alone are there and those that read the device trace are
not."""
import pytest

from benchmark import spans as S
from optix_raytracer_tpu_torch.telemetry import Span

E = S.Event


def window(shift=0, lead=0):
    """Two launches in [0, 1000) ns. Launch 0: the camera and film reset,
    then the launch, whose camera pack syncs and whose kernel call starts
    the fused kernel; the harness's sync after it. Launch 1: the camera
    copies its numbers and syncs; the kernel call at `shift` ns later than
    its span on the profiler's clock; an eager op after every span. The
    device's stamps `lead` ns ahead of the host's."""
    spans = [
        Span(0, "camera.params", None, 10, 30, -1, 0),
        Span(1, "film.reset", None, 30, 40, -1, 0),
        Span(2, "engine.render_accumulate", None, 50, 400, -1, 0),
        Span(3, "engine.render_sum_fused", None, 60, 380, 2, 0),
        Span(4, "engine.pack_camera", None, 70, 150, 3, 0),
        Span(5, "kernels.launch", "pt_fused_cornell", 200, 260, 3, 0),
        Span(6, "engine.merge", None, 380, 395, 2, 0),
        Span(7, "camera.params", None, 500, 520, -1, 1),
        Span(8, "film.reset", None, 520, 530, -1, 1),
        Span(9, "engine.render_accumulate", None, 540, 900, -1, 1),
        Span(10, "engine.render_sum_fused", None, 550, 880, 9, 1),
        Span(11, "kernels.launch", "pt_fused_cornell", 700, 720, 10, 1),
        Span(12, "engine.merge", None, 880, 890, 9, 1),
    ]
    runtime = [E("cudaStreamSynchronize", 100, 140, 0),
               E("cudaLaunchKernel", 210, 220, 7),
               E("cudaLaunchKernel", 385, 388, 8),
               E("cudaDeviceSynchronize", 400, 495, 0),
               E("cudaMemcpyAsync", 505, 509, 10),
               E("cudaStreamSynchronize", 509, 515, 0),
               E("cudaLaunchKernel", 705 + shift, 715 + shift, 9),
               E("cudaLaunchKernel", 905, 907, 11)]
    device = [E("void ort_fused::pt_fused_kernel<0, false, false, false>"
                "(float const*)", 230, 480, 7),
              E("elementwise_kernel", 480, 490, 8),
              E("Memcpy HtoD (Pageable -> Device)", 510, 512, 10),
              E("void ort_fused::pt_fused_kernel<0, false, false, false>"
                "(float const*)", 720, 950, 9),
              E("elementwise_kernel", 960, 970, 11)]
    setup = [Span(0, "scene.upload", None, 0, 10 ** 9, -1, 0),
             Span(1, "kernels.load", None, 10, 20, 0, 0),
             Span(2, "engine.render_accumulate", None, 2 * 10 ** 9,
                  6 * 10 ** 9, -1, 0),
             Span(3, "kernels.launch", "pt_fused_cornell", 2 * 10 ** 9 + 1,
                  5 * 10 ** 9, 2, 0),
             Span(4, "kernels.build", None, 2 * 10 ** 9 + 2,
                  4 * 10 ** 9 + 2, 3, 0),
             Span(5, "kernels.load", None, 4 * 10 ** 9 + 3,
                  4.5 * 10 ** 9 + 3, 3, 0),
             Span(6, "scene.fused_tables", None, 5 * 10 ** 9,
                  5.25 * 10 ** 9, 2, 0)]
    device = [e._replace(start=e.start + lead, end=e.end + lead)
              for e in device]
    return {"program": S.ctx_program(spans, setup, (0, 1000), runtime,
                                     device)}


def test_each_quantity_on_a_known_window():
    ctx = window()
    # the camera and the reset: 20 + 10 ns a frame
    assert S.app_host_ms_per_frame(ctx) == pytest.approx(30e-6)
    # 350 - 60 and 360 - 20 ns
    assert S.engine_self_ms_per_launch(ctx) == pytest.approx(315e-6)
    # the pack's sync and the camera's; the harness's own is outside
    assert S.host_syncs_per_launch(ctx) == 1.0
    # idle [0, 230) [490, 510) [512, 720) [950, 960) [970, 1000): 498 ns,
    # 418 of them inside a span (30 + 180 + 28 + 180)
    assert S.device_idle_program_pct(ctx) == pytest.approx(41.8)
    assert S.device_idle_pct(ctx["program"]) == pytest.approx(49.8)
    # 1 + 2 + 0.5 + 0.25 s; the load nested in the upload counts once
    assert S.program_setup_s(ctx) == pytest.approx(3.75)


def test_quantities_without_the_spans_or_the_trace():
    for name, (read, _) in S.QUANTITIES.items():
        assert read({}) is None, name
    p = window()["program"]
    cpu = {"program": dict(p, runtime=[], device=[])}
    assert S.host_syncs_per_launch(cpu) is None
    assert S.device_idle_program_pct(cpu) is None
    assert S.engine_self_ms_per_launch(cpu) is not None
    still = {"program": dict(p, spans=[s for s in p["spans"]
                                       if s.name not in S.APP_SPANS])}
    assert S.app_host_ms_per_frame(still) is None
    assert S.program_setup_s({"program": dict(p, setup=[])}) is None


def test_containment_tells_a_shifted_clock():
    assert S.containment(window()["program"]) == (1.0, 2)
    assert S.containment(window(shift=50)["program"]) == (0.5, 2)


def drifting(n=400, lead0=-400_000, rate=1e-4):
    """n launches 1 ms apart: a kernel 5 us after its call, 500 us long,
    the host's sync returning 3 us after it ends; the device's stamps
    lead0 ns ahead of the host's at 0 and gaining `rate` ns a ns."""
    runtime, device = [], []
    for k in range(n):
        t = k * 1_000_000
        lead = round(lead0 + rate * (t + 5_000))
        runtime.append(E("cudaLaunchKernel", t, t + 4_000, k + 1))
        device.append(E("kernel", t + 5_000 + lead, t + 505_000 + lead,
                        k + 1))
        runtime.append(E("cudaDeviceSynchronize", t + 10_000, t + 508_000,
                         0))
    return dict(spans=[], setup=[], window=(0, n * 1_000_000),
                runtime=runtime, device=device)


def test_device_clock_alignment():
    """Causality bounds each lead (the kernel 5 us after its call, the sync
    back 3 us after the kernel), and the line through the bins' bands
    gives the drift back: every constraint is kept after the alignment."""
    up, lo = S.lead_constraints(window()["program"])
    assert min(v for _, v in up) == 5 and max(v for _, v in lo) == -3
    p = drifting()
    assert S.causal_share(p) < 0.6
    q, (t0, a, b) = S.align_device(p)
    assert b == pytest.approx(1e-4, rel=1e-3)
    assert a + b * (0 - t0) == pytest.approx(-400_000 + 1_000, abs=600)
    assert S.causal_share(q) == 1.0
    steady, _ = S.align_device(drifting(lead0=0, rate=0.0))
    assert [e.start for e in steady["device"]] == [
        e.start - 1_000 for e in drifting(lead0=0, rate=0.0)["device"]]
    ahead = window(lead=300)["program"]
    assert S.device_idle_program_pct({"program": ahead}) != pytest.approx(
        41.8, abs=1)
    assert S.device_idle_program_pct(
        {"program": S.align_device(ahead, bin_ns=2000)[0]}) == \
        pytest.approx(41.8, abs=0.2)
    assert S.align_device(dict(ahead, runtime=[])) == (
        dict(ahead, runtime=[]), None)


def test_gap_labels_name_the_span():
    assert S.idle_gaps(window()["program"]) == [
        ["camera.params / cudaStreamSynchronize", pytest.approx(208e-9)],
        ["cudaDeviceSynchronize", pytest.approx(20e-9)],
        ["host: python", pytest.approx(10e-9)]]


def test_table_splits_the_idle_time():
    p = window()["program"]
    rows = {r["name"]: r for r in S.table(p)}
    assert list(rows)[-1] == "(no span)"
    # ms a launch, 2 launches
    assert sum(r["idle_ms"] for r in rows.values()) * 2e6 == pytest.approx(
        498)
    assert rows["(no span)"]["idle_ms"] * 2e6 == pytest.approx(80)
    assert rows["kernels.launch"]["device_ms"] * 2e6 == pytest.approx(480)
    assert rows["engine.merge"]["device_ms"] * 2e6 == pytest.approx(10)
    assert rows["camera.params"]["device_ms"] * 2e6 == pytest.approx(2)
    assert rows["(no span)"]["device_ms"] * 2e6 == pytest.approx(10)
    assert rows["engine.pack_camera"]["syncs"] == 0.5
    assert rows["(no span)"]["syncs"] == 0.5
    assert rows["engine.render_accumulate"]["per_launch"] == 1.0
    # the root's own time: 350 - 335 and 360 - 340 ns
    assert rows["engine.render_accumulate"]["self_ms"] * 2e6 == \
        pytest.approx(35)


@pytest.mark.parametrize("workload, app", [("cornell-interactive", True),
                                           ("cornell-progressive", False)])
def test_the_runner_on_the_cpu(workload, app, tiny_root):
    """On the CPU the quantities read from spans alone are there, and the
    set-up's; those of the device trace are not."""
    code, res = S.run(tiny_root, workload, 2 ** 31 + 5, 0.2, device="cpu")
    assert code == 0 and res["correct"]
    got = res["program"]["metrics"]
    want = {"engine_self_ms_per_launch", "program_setup_s"}
    if app:
        want.add("app_host_ms_per_frame")
    assert set(got) == want
    assert all(v["value"] > 0 for v in got.values())
    assert res["program"]["launches"] >= 1
    names = {r["name"] for r in res["program"]["table"]}
    assert {"engine.render_accumulate", "engine.merge"} <= names
