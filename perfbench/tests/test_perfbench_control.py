"""On the card, at each cell's own size: the program reads under every
limit of its output check, and the control (the reference put in the
program's place one precision lower, the configuration's "control")
reads over at least one, on three seeds. Skips without a card.

    python -m pytest perfbench/tests/test_perfbench_control.py -m gpu -q
"""

import pytest
import torch

from calibrate import readings
from harness.main import ROOT, Cell, load_json

CELLS = [w["name"] for w in load_json(ROOT, "BENCHMARK.json")["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = Cell(name)
    mode = cell.cfg["control"]
    prog, ctrl = readings(cell, seed, 2.0, [mode])
    lim = {k: v["limit"] for k, v in cell.limits.items()}
    assert all(prog[k] <= lim[k] for k in lim), prog
    assert any(ctrl[k] > lim[k] for k in lim), ctrl
