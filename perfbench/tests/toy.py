"""Cells cut to a size the CPU runs in seconds, for the tests: 64 px
patches and a batch of 2 (the model keeps its widths and depth), the
scene's tiles at 200 px. `pure=True` also runs the program in float32 with
its kernels' plain versions off (convseg.disabled: the NHWC routing of
plain PyTorch convolutions), where it computes what the float32
reference computes."""

import contextlib

from harness.main import Cell, execute


def cell(name, pure=False):
    c = Cell(name)
    c.cfg["img_size"] = 64
    if pure:
        c.cfg["dtype"] = "float32"
    t = c.traffic
    if t["generator"] == "train":
        t.update(pool=8, patch=64, batch=2, warm_steps=1, trace_steps=1)
    else:
        t.update(tile=200, tiles=2, patch=64, batch=4, warm_tiles=1,
                 trace_tiles=1, check_tiles=2, check_patches=3, cell_px=16,
                 bn_patches=4)
    return c


def run(name, seed=3, seconds=0.3, trace=0, pure=False, hook=None):
    """execute() of the toy cell on the CPU; returns (result, rows, job)."""
    from resuneta_torch.ops import convseg

    scope = convseg.disabled() if pure else contextlib.nullcontext()
    with scope:
        return execute(cell(name, pure), seed, seconds, trace, "cpu",
                       job_hook=hook)
