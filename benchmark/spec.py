"""`BENCHMARK.json` and the files it names: a cell's configuration, traffic
mix, check limits and per-layer readers, each found by name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent


class Cell:
    """One entry of `workloads` with what it names: `config` (the
    configuration's file), `traffic` (`traffic/<name>.json`), `limits`
    (`limits/<workload>.json`: the check's pixels and limits), and the
    end-to-end and per-layer metrics it reports."""

    def __init__(self, root: Path, spec: dict, workload: str):
        self.root = Path(root)
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        self.entry = by_name[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config = _load(self.root / conf["file"])
        self.traffic = _load(self.root / spec["paths"][0] / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = _load(self.root / spec["paths"][0] / "limits"
                            / f"{workload}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if _in(m, workload)]
        self.per_layer = [m for m in spec["per_layer"] if _in(m, workload)]
        self.metrics_dir = self.root / spec["paths"][0] / "metrics"


def _in(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def base_name(name: str) -> str:
    """A metric's quantity: its name before the first dot
    (`msamples_per_s.interactive` → `msamples_per_s`)."""
    return name.split(".", 1)[0]


def load(root: Path) -> dict:
    return _load(Path(root) / "BENCHMARK.json")


def reader(metrics_dir: Path, name: str):
    """The per-layer metric's reader, `metrics/<name>.py`'s `read(ctx)`. A
    quantity split by traffic mix, `<base>.<mix>`, reads as
    `metrics/<base>.py` where it has no file of its own."""
    path = Path(metrics_dir) / f"{name}.py"
    if not path.is_file():
        path = Path(metrics_dir) / f"{base_name(name)}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
