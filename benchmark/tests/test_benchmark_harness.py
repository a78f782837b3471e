"""The harness on the CPU: `BENCHMARK.json` against its format's rules,
a cell added by files alone, no result without a card or without the
program, and a run whose timed path is broken underneath coming out not
correct (the check's teeth), while a sound run comes out correct."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, spec as spec_mod

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    None: {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_its_format_rules():
    b = load()
    assert set(b) == KEYS[None]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        for e in b[group]:
            assert set(e) - {"workloads"} == KEYS[group], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark/limits" / f"{w['name']}.json").is_file()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert callable(spec_mod.reader(ROOT / "benchmark/metrics", m["name"]))
    for m in b["end_to_end"]:
        assert spec_mod.base_name(m["name"]) in (
            "msamples_per_s", "launch_ms_p95", "setup_s")
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    """Every cell reports setup_s, another end-to-end metric and a per-layer
    metric, and every `moves` names an end-to-end metric of every cell that
    reports the per-layer metric."""
    b = load()
    for w in b["workloads"]:
        cell = spec_mod.Cell(ROOT, b, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def add_cell(root: Path):
    """A configuration, a traffic mix, a per-layer metric, the check's
    limits and their BENCHMARK.json entries, by new files alone."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "cornell.json").read_text())
    cfg["camera"]["fov_y"] = 50.0
    (bench / "configs" / "cornell_wide.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "still2.json").write_text(json.dumps(dict(
        samples_per_launch=2, film="accumulate", warmup_launches=1,
        pixel_sets=1,
        orbit=dict(offset_deg=0.5, amplitude_deg=0.0, period_launches=1))))
    (bench / "metrics" / "launches_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['launches'])\n")
    (bench / "limits" / "cornell_wide-still2.json").write_text(json.dumps(
        dict(check_pixels=32, film_rel_l1=1e-3)))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(name="cornell_wide", source="x",
                             file="benchmark/configs/cornell_wide.json",
                             reduced=[], why="a wider lens"))
    b["workloads"].append(dict(name="cornell_wide-still2",
                               config="cornell_wide", traffic="still2",
                               chips=1, why="a new cell"))
    for m in b["end_to_end"]:
        if m["name"] == "msamples_per_s":
            m["workloads"].append("cornell_wide-still2")
    b["per_layer"].append(dict(name="launches_traced", unit="launches",
                               better="higher", source="program_counter",
                               layer="app loop", moves="msamples_per_s",
                               workloads=["cornell_wide-still2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_a_new_cell_needs_only_new_files(tiny_root):
    add_cell(tiny_root)
    code, res = harness.run(tiny_root, "cornell_wide-still2", 11, 0.2,
                            trace=True, device="cpu")
    assert code == 0 and res["correct"]
    assert res["metrics"]["launches_traced"]["value"] == res["attempted"]
    code, res = harness.run(tiny_root, "cornell_wide-still2", 12, 0.2,
                            trace=False, device="cpu")
    assert code == 0 and res["correct"]
    assert set(res["metrics"]) == {"msamples_per_s", "launch_ms_p95",
                                   "setup_s"}


def _last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def test_no_card_no_result():
    """The command line on a machine without CUDA: no result, exit 2."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "cornell-progressive", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == harness.EXIT_NO_CARD
    assert _last_json(out.stdout) is None
    assert "no result" in out.stderr


def test_without_the_program_no_result(tiny_root):
    """Only BENCHMARK.json and the benchmark's files: the run fails."""
    code = ("import sys\n"
            "sys.modules['optix_raytracer_tpu_torch'] = None\n"
            f"sys.path.insert(0, {str(tiny_root)!r})\n"
            "from benchmark import harness\n"
            f"harness.run({str(tiny_root)!r}, 'cornell-progressive', 1, 0.2,"
            " False, device='cpu')\n"
            "print('{}')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None


def unchanged_state(engine, orig_accumulate, orig_sum):
    def f(scene, cam, film, *a, **k):
        _, rays = orig_accumulate(scene, cam, film, *a, **k)
        return film, rays
    return "render_accumulate", f


def half_the_batch(engine, orig_accumulate, orig_sum):
    def f(scene, cam, w, h, subframe, spl, **k):
        total, rays = orig_sum(scene, cam, w, h, subframe, spl // 2, **k)
        return total * (spl / (spl // 2)), rays
    return "render_sum", f


def altered_answer(engine, orig_accumulate, orig_sum):
    def f(*a, **k):
        total, rays = orig_sum(*a, **k)
        total = total.clone()
        total.view(-1, 3)[::8] *= 2.0
        return total, rays
    return "render_sum", f


CELLS = ("cornell-progressive", "cornell-interactive")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [None, unchanged_state, half_the_batch,
                                   altered_answer])
def test_a_broken_timed_path_is_not_correct(workload, fault, tiny_root,
                                            monkeypatch):
    """Each fault a cell can have, planted under the harness (the launch
    that leaves the film as it was, half the samples with the mean over the
    rest, one pixel in eight altered where the launch produces it) comes
    out not correct; with none the run is correct. One card: no exchange
    between chips to leave out."""
    from optix_raytracer_tpu_torch.wavefront import engine
    if fault is not None:
        name, f = fault(engine, engine.render_accumulate, engine.render_sum)
        monkeypatch.setattr(engine, name, f)
    code, res = harness.run(tiny_root, workload, 2 ** 31 + 9, 0.3,
                            trace=False, device="cpu")
    assert code == 0
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("config", ["cornell"])
def test_scene_arrays_equal_the_builtins(config):
    """The benchmark's scene arrays are the port's builtins', bit for bit:
    `cornell_box`."""
    import numpy as np
    from optix_raytracer_tpu_torch.scene import builtins as B
    from benchmark import scenes
    spec = json.loads((ROOT / "benchmark/configs" / f"{config}.json")
                      .read_text())
    got = scenes.build(spec["scene"])
    verts, idx, tri_mat = B.quads_to_triangles(B._CORNELL_QUADS)
    normals = None
    light = (B.CORNELL_LIGHT_CORNER, B.CORNELL_LIGHT_V1,
             B.CORNELL_LIGHT_V2, B.CORNELL_LIGHT_EMISSION)
    mats = B.CORNELL_MATERIALS
    for key, want in (("vertices", verts), ("indices", idx),
                      ("tri_mat", tri_mat), ("normals", normals)):
        if want is None:
            assert got[key] is None
        else:
            assert got[key].dtype == want.dtype
            assert np.array_equal(got[key], want), key
    for k, want in zip(("corner", "v1", "v2", "emission"), light):
        assert np.array_equal(np.asarray(got["light"][k], np.float32),
                              np.asarray(want, np.float32)), k
    assert len(got["materials"]) == len(mats)
    for m, want in zip(got["materials"], mats):
        assert tuple(m["base_color"]) == tuple(want["base_color"])
        assert tuple(m.get("emission", (0.0, 0.0, 0.0))) == tuple(
            want.get("emission", (0.0, 0.0, 0.0)))
    assert got["indices"].shape[0] == 32
