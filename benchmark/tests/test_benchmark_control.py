"""The check's control (`benchmark/control.py`: the reference in bfloat16 in
the program's place) comes out not correct against every cell's limit: on
the CPU at tiny sizes, and on the card at a cell's own size."""
import json
from pathlib import Path

import pytest

from benchmark import control

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("cornell-progressive", "cornell-interactive")


def limit(workload):
    return json.loads((ROOT / "benchmark/limits" / f"{workload}.json")
                      .read_text())["film_rel_l1"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22, 23])
def test_control_fails_at_tiny_size(workload, seed, tiny_root):
    values = control.control_numbers(tiny_root, workload, seed, 3, "cpu")
    assert values["film_rel_l1"] > limit(workload)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(workload, card):
    values = control.control_numbers(ROOT, workload, 31, 8, card)
    assert values["film_rel_l1"] > limit(workload)
