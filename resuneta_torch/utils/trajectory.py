"""Short-trajectory gate: the train step against a pinned loss series
(resuneta_tpu/utils/trajectory.py).

The f32 parity tests hold single steps to the JAX package; nothing else
holds the bf16 step on the card over several steps, where a bf16-specific
break (in a kernel's backward, say) would show only as a convergence miss
hundreds of steps later. This module fixes the reference's tiny
deterministic workload: the 64 px multitask ResUnet-a d6, the uint8
pipeline, Tanimoto on the four heads, Adam, batches drawn from
default_rng(1234) in the reference's order. Its first N_STEPS losses from
the port's CPU f32 step are REFERENCE_LOSSES; `check` passes a series
whose every loss is within BAND of them (|loss / ref - 1|). `chip_smoke.py`
replays the workload in bf16 on the card; tests/test_torch_trajectory.py
re-derives the pin on the CPU, so it cannot go stale silently.

The port seeds its own initial weights (models.ResUnetA's generator), so
its pin is its own; `params` takes other weights, such as the JAX
package's PRNGKey(0) init carried across by convert.from_flax.

Regenerate after an intentional numerics change:
    python -m resuneta_torch.utils.trajectory
"""

import numpy as np
import torch

N_STEPS = 5
PS, BS, NC = 64, 4, 5
LR = 1e-3
HEADS = ("seg", "bound", "dist", "color")

# the port's CPU f32 step on the workload below, from its seeded init
# (regenerated with the module CLI)
REFERENCE_LOSSES = [1.961323, 1.8520737, 1.7991606, 1.752377, 1.724613]

# |loss / ref - 1| tolerated a step (the reference's BAND): bf16 compute
# and the kernels' reduction orders drift a few 1e-3 by step 5; a broken
# backward leaves it in one or two steps
BAND = 0.05


def batches():
    """The N_STEPS raw batches, drawn as the reference draws them."""
    rng = np.random.default_rng(1234)
    out = []
    for _ in range(N_STEPS):
        out.append({
            "image_u8": rng.integers(0, 256, (BS, PS, PS, 3),
                                     dtype=np.uint8),
            "label_ids": rng.integers(0, NC, (BS, PS, PS)).astype(np.uint8),
            "aug": rng.integers(0, 5, BS).astype(np.int32)})
    return out


def make_workload(dtype=None, device=None, params=None):
    """(state, step_fn, batches) of the fixed workload on `device` (None:
    the card; "cpu" for the plain path), compute dtype `dtype` (None:
    float32), from the port's seeded init or from `params` (a state_dict,
    e.g. convert.from_flax of the JAX package's variables)."""
    from ..data import make_device_pipeline
    from ..device import resolve_device
    from ..losses import make_losses
    from ..models import ResUnetA
    from ..train import create_train_state, make_train_step

    dev = resolve_device(device)
    model = ResUnetA(NC, img_size=PS, multitasking=True,
                     dtype=dtype or torch.float32, device=dev)
    if params is not None:
        model.load_state_dict(params)
    state = create_train_state(model, "adam", LR)
    step = make_train_step(make_losses("tanimoto"), {h: 1.0 for h in HEADS},
                           True, preprocess=make_device_pipeline(
                               NC, norm_type=1, device=dev), device=dev)
    return state, step, batches()


def run_losses(dtype=None, device=None, params=None):
    """The workload's N_STEPS losses (make_workload's arguments)."""
    state, step, raw = make_workload(dtype, device, params)
    losses = []
    for batch in raw:
        state, row = step(state, batch)
        losses.append(float(row[0]))
    return losses


def check(losses, band=BAND):
    """True when every step's loss is within `band` of the pinned
    series."""
    return len(losses) == N_STEPS and all(
        abs(l / r - 1.0) <= band for l, r in zip(losses, REFERENCE_LOSSES))


if __name__ == "__main__":
    series = run_losses(device="cpu")
    print("REFERENCE_LOSSES =", [round(l, 7) for l in series])
