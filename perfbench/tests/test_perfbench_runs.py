"""Each cell's set-up, window, traced slice and output check at a toy size
on the CPU (the look for a card skipped), and the check's faults: with
the program's timed path broken underneath, `correct` comes out false.

The toy cells run the program in float32 with its kernels' plain versions
off (toy.py `pure`), where it computes what the float32 reference
computes, so an unbroken run is correct under the cells' limits and a
broken one is not."""

import json

import pytest
import torch

import toy
from harness.main import ROOT, load_json

CELLS = [w["name"] for w in load_json(ROOT, "BENCHMARK.json")["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("name", CELLS)
def test_a_toy_run_prints_the_contracts_line(name, trace):
    result, rows, _ = toy.run(name, seed=2 ** 31 + 5, trace=trace)
    json.dumps(result)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    cell = toy.cell(name)
    want = cell.per_layer() if trace else cell.end_to_end()
    got = set(result["metrics"])
    if trace:
        assert "breakdown" in result
        assert {"busy_s", "window_s"} <= set(result["device"])
        # the kernel rooflines find no kernels on the CPU and stay silent
        assert got <= {m["name"] for m in want}
        assert got >= {m["name"] for m in want if "roofline" not in
                       m["name"]}
    else:
        # step times come from CUDA events: none on the CPU
        assert got == {m["name"] for m in want} - {"train_step_p90_ms"}
    assert [r[0] for r in rows] == list(result["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_pure_program_is_correct(name):
    result, rows, _ = toy.run(name, pure=True)
    assert result["correct"], rows


def _unchanged(job):
    step = job.step

    def broken(state, raw):
        before = [p.detach().clone() for p in state.model.parameters()]
        state, row = step(state, raw)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return state, row

    job.step = broken


def _half_batch(job):
    step = job.step

    def broken(state, raw):
        n = len(next(iter(raw.values()))) // 2
        return step(state, {k: v[:n] for k, v in raw.items()})

    job.step = broken


def _answer_altered(job):
    fn, nc = job.fn, job.cfg["num_classes"]

    def broken(x):
        ids = fn(x).clone()
        ids[:, :8, :8] = ((ids[:, :8, :8].long() + 1) % nc).to(ids.dtype)
        return ids

    job.fn = broken


def _half_of_the_tiles_batch(job):
    fn = job.fn

    def broken(x):
        half = fn(x[:len(x) // 2])
        return torch.cat([half, half, half])[:len(x)]

    job.fn = broken


# the faults each generator's cells can have
BY_GENERATOR = {"train": (_unchanged, _half_batch),
                "scene": (_answer_altered, _half_of_the_tiles_batch)}
FAULTS = [(n, f) for n in CELLS
          for f in BY_GENERATOR[toy.cell(n).traffic["generator"]]]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_fault_makes_the_run_incorrect(name, fault):
    result, rows, _ = toy.run(name, pure=True, hook=fault)
    assert not result["correct"], rows
