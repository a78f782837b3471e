"""Fixtures of the benchmark's tests: a copy of the benchmark at tiny sizes,
and the card for the tests marked `gpu`, decided inside the fixture."""
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def make_tiny_root(dst: Path, width=32, height=24, pixels=64) -> Path:
    """BENCHMARK.json and benchmark/ copied to dst, every configuration cut
    to width x height and every check to `pixels` pixels. The
    ray gap's limits are set for the cells' sizes, where the stratified
    estimate reads 0.01-2%; at these sizes it spreads by several percent,
    so the copies compare the film alone."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    for p in (dst / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["width"], c["height"] = width, height
        p.write_text(json.dumps(c))
    for p in (dst / "benchmark" / "limits").glob("*.json"):
        lim = json.loads(p.read_text())
        lim["check_pixels"] = pixels
        lim.pop("rays_rel_gap", None)
        p.write_text(json.dumps(lim))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "checkout")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
