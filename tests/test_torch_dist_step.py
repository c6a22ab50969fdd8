"""The port's data-parallel train and eval steps on the CPU: two gloo ranks
(tests/torch_dist_ranks.py), each with 4 rows of a global batch of 8,
against the JAX package's shard_map step over make_mesh(2) on the same
weights (convert.from_flax) and batch, and against the port's own step in
one process on all 8 rows; then the eval row over the ranks against the
port's in one process.

The step is tests/test_shardmap_step.py's: the 64 px multitask ResUnet-a
d6, f32, SGD (its update is linear in the gradient, so the parameters after
the step bound the gradients' mismatch), Tanimoto on the four heads, uint8
patches through make_device_pipeline. Sync-BN, the Tanimoto volumes, the
gradient mean and the metric row each reduce over the ranks. The port's
segments run K1/K2's plain versions (bf16 z and taps) and JAX's CPU path
f32 ones, so the limits are the port's step tests': the rows at
test_shardmap_step.py's _assert_rows_close, the SGD update at
test_torch_train.py's bf16 band (0.1 relative L2 over every parameter,
3e-2 each head leaf), each BN running buffer within 5e-3 relative L2. The
two ranks' parameters and buffers are equal bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch import convert
from resuneta_torch import models as tm
from resuneta_tpu.data import make_device_pipeline as jmake_device_pipeline
from resuneta_tpu.losses import make_losses as jmake_losses
from resuneta_tpu.models import resuneta as jm
from resuneta_tpu.parallel import make_mesh
from resuneta_tpu.parallel.mesh import replicate_state as jreplicate_state
from resuneta_tpu.parallel.mesh import shard_batch as jshard_batch
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train.state import TrainState as JTrainState
from resuneta_tpu.train.state import make_optimizer as jmake_optimizer
from test_shardmap_step import _assert_rows_close
from test_torch_train import NC, PS, _grad_err, step_variables
import torch_dist_ranks as ranks

BS, LR = 8, 1e-3
HEADS = ("seg", "bound", "dist", "color")
HEAD_LEAVES = ("seg1", "seg2", "seg3", "Conv_6", "Conv_7", "Conv_9",
               "Conv_10", "Conv_11")


def _raw(seed=0):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (BS, PS, PS, 3), dtype=np.uint8),
            "label_ids": rng.integers(0, NC, (BS, PS, PS)).astype(np.uint8),
            "aug": rng.integers(0, 5, BS).astype(np.int32)}


@functools.cache
def _jax_mesh_step():
    """The JAX shard_map step over make_mesh(2): (new params and
    batch_stats as the port's state_dict, train row)."""
    v = step_variables()
    jmod = jm.ResUnetA(NC, img_size=PS, multitasking=True)
    tx = jmake_optimizer("sgd", LR)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"],
                        opt_state=tx.init(v["params"]), tx=tx,
                        apply_fn=jmod.apply)
    mesh = make_mesh(2)
    weights = {h: 1.0 for h in HEADS}
    pipe = jmake_device_pipeline(NC, 1)
    step = jmake_train_step(jmake_losses("tanimoto"), weights, True,
                            preprocess=pipe, donate=False, mesh=mesh)
    batch = jshard_batch({k: jnp.asarray(a) for k, a in _raw().items()},
                         mesh)
    new, row = step(jreplicate_state(state, mesh), batch)
    sd = convert.from_flax({"params": jax.device_get(new.params),
                            "batch_stats": jax.device_get(new.batch_stats)})
    return sd, np.asarray(row)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_step")
    model = tm.ResUnetA(NC, img_size=PS, multitasking=True, device="cpu")
    sd0 = convert.from_flax(step_variables(), model)
    torch.save(sd0, tmp / "weights.pt")
    raw = _raw()
    got = ranks.run_ranks(ranks.multitask_step, tmp, str(tmp / "weights.pt"),
                          raw, LR)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ranks.multitask_step(None, str(tmp / "weights.pt"), raw, LR)
    finally:
        torch.set_num_threads(n)
    return {"sd0": sd0, "ranks": got, "one": one}


def test_ranks_run_the_kernels_path_and_agree_bit_for_bit(runs):
    """Each rank runs the 44 fused segments each way (K1/K2) and one call
    each of K5 and K6 on its 4 rows, as one process does on 8; the ranks
    end with the same parameters and BN buffers, bit for bit, and the same
    rows."""
    r0, r1 = runs["ranks"]
    assert r0["counts"] == r1["counts"] == runs["one"]["counts"] == \
        [44, 44, 1, 1]
    assert r0["step"] == r1["step"] == 1
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    np.testing.assert_array_equal(r0["row"], r1["row"])
    np.testing.assert_array_equal(r0["eval_row"], r1["eval_row"])


def _updates(sd, sd0):
    return {k: sd[k] - sd0[k] for k in sd0 if not k.endswith((".mean",
                                                              ".var"))}


@pytest.mark.parametrize("against", ["jax_mesh", "port_one_process"])
def test_train_step_matches(runs, against):
    """The rank's row, its SGD update (-lr * the mean gradient) and its BN
    running buffers against the JAX shard_map step over 2 devices, and
    against the port's one-process step on the 8 rows."""
    got = runs["ranks"][0]
    if against == "jax_mesh":
        want_sd, want_row = _jax_mesh_step()
    else:
        want_sd, want_row = runs["one"]["state_dict"], runs["one"]["row"]
    _assert_rows_close(got["row"], want_row)
    sd0 = runs["sd0"]
    du, dw = _updates(got["state_dict"], sd0), _updates(want_sd, sd0)
    assert sorted(du) == sorted(dw)
    a = torch.cat([du[k].ravel() for k in dw]).double()
    b = torch.cat([dw[k].ravel() for k in dw]).double()
    assert (a - b).norm() / b.norm() < 0.1
    heads = [k for k in dw if k.split(".")[0] in HEAD_LEAVES]
    assert len(heads) == 16
    worst = max(_grad_err(du[k].numpy(), dw[k].numpy(), atol=1e-9)
                for k in heads)
    assert worst < 3e-2, worst
    bufs = [k for k in sd0 if k.endswith((".mean", ".var"))]
    worst = max(_grad_err(got["state_dict"][k].numpy(),
                          want_sd[k].numpy(), atol=0) for k in bufs)
    assert worst < 5e-3, worst


def test_eval_row_matches_one_process(runs):
    """The eval step's row over the ranks (running statistics; the
    Tanimoto volumes and the row reduced over the ranks) after the step,
    against the port's eval step in one process on the 8 rows (whose
    forward tests/test_torch_model.py holds against Flax)."""
    _assert_rows_close(runs["ranks"][0]["eval_row"],
                       runs["one"]["eval_row"])
