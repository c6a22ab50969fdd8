"""The port's space axis on the CPU (resuneta_torch/parallel: the height
of every image and activation sharded over a (data, space) group, with
halo exchanges): four gloo ranks, spawned once for the module
(tests/torch_dist_ranks.py `space_cases`), against one process.

- `halo` forward and backward against slicing a zero-padded whole plane,
  d in {1, 3, 31} over 2 bands of 16 rows and 4 bands of 8 (a halo wider
  than a band reaches several neighbours): equal values, gradients within
  1e-6;
- UNet(3 classes, 8 filters) at 32 px, SGD, cross entropy, on a 2 x 2 mesh
  against the JAX package's unsharded step on the same weights
  (convert.from_flax), at tests/test_spatial_sharding.py's rtol 2e-4,
  atol 1e-5 on the row and the parameters after the step;
- the 64 px multitask ResUnet-a d6 (the pipeline on whole planes, Tanimoto
  on four heads) on a 1 x 2 mesh, with and without remat, and its eval
  step, against the port's unsharded steps and the JAX package's, at the
  same tolerance. The space step runs the reference's GSPMD routing, K1-K4
  off (convseg.disabled), so the unsharded steps run inside that scope on
  both sides (the JAX package's convseg.disabled): every conv then in f32;
- make_mesh_2d's layout (rank = data index x 2 + space index);
- predict_patches over a 2 x 2 group against one process, the kernels
  live (no height is sharded there);
- the refusals: H not divisible by the bands or a band by the model's
  depth, an uneven batch, forced dense routes under the scope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch import convert, losses
from resuneta_torch.data import make_device_pipeline
from resuneta_torch.infer.sliding import make_apply_fn, predict_patches
from resuneta_torch.models import ResUnetA, UNet
from resuneta_torch.ops import convseg, densemm
from resuneta_torch.parallel import (DataGroup, SpaceMesh, axis,
                                     shard_batch_spatial)
from resuneta_torch.train import (create_train_state, make_eval_step,
                                  make_train_step)
from resuneta_tpu.data import make_device_pipeline as jmake_device_pipeline
from resuneta_tpu.losses import make_losses as jmake_losses
from resuneta_tpu.models import ResUnetA as JResUnetA
from resuneta_tpu.models import UNet as JUNet
from resuneta_tpu.ops.pallas import convseg as jconvseg
from resuneta_tpu.train import create_train_state as jcreate_train_state
from resuneta_tpu.train import make_eval_step as jmake_eval_step
from resuneta_tpu.train import make_optimizer as jmake_optimizer
from resuneta_tpu.train import make_train_step as jmake_train_step
from resuneta_tpu.train.state import TrainState as JTrainState
from test_torch_train import step_variables
from util_synth import synth_patches
from util_torch import one_thread  # noqa: F401  (a fixture)
from util_torch import one_thread_under_xdist
import torch_dist_ranks as ranks

TOL = dict(rtol=2e-4, atol=1e-5)    # tests/test_spatial_sharding.py:31-32
ROWS = (1, 3, 31)                   # halo widths
NC, PS, LR = 5, 64, 1e-3
HEADS = {h: 1.0 for h in ("seg", "bound", "dist", "color")}


def _planes():
    rng = np.random.default_rng(0)
    planes = rng.standard_normal((4, 3, 32, 5)).astype(np.float32)
    weights = {S: {d: rng.standard_normal(
        (4, 3, S, 32 // S + 2 * d, 5)).astype(np.float32) for d in ROWS}
        for S in (2, 4)}
    return planes, weights


def _unet_batch():
    img, ids = synth_patches(8, 32, 3, 3, seed=0)
    return {"image": img.astype(np.float32) / 255.0,
            "seg": np.eye(3, dtype=np.float32)[ids]}


def _raw():
    rng = np.random.default_rng(3)
    return {"image_u8": rng.integers(0, 256, (2, PS, PS, 3), dtype=np.uint8),
            "label_ids": rng.integers(0, NC, (2, PS, PS)).astype(np.uint8),
            "aug": rng.integers(0, 5, 2).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("space")
    jmod = JUNet(num_classes=3, base_filters=8)
    jstate = jcreate_train_state(jmod, jax.random.PRNGKey(0), (1, 32, 32, 3),
                                 "sgd", LR)
    unet_sd = convert.from_flax({"params": jax.device_get(jstate.params)},
                                UNet(3, base_filters=8, device="cpu"))
    torch.save(unet_sd, tmp / "unet.pt")
    model = ResUnetA(NC, img_size=PS, multitasking=True, device="cpu")
    res_sd = convert.from_flax(step_variables(), model)
    torch.save(res_sd, tmp / "resuneta.pt")
    planes, weights = _planes()
    patches = np.random.default_rng(5).uniform(
        0, 1, (5, 32, 32, 3)).astype(np.float32)
    got = ranks.run_ranks(
        ranks.space_cases, tmp, planes, weights, ROWS,
        (str(tmp / "unet.pt"), _unet_batch(), LR),
        (str(tmp / "resuneta.pt"), _raw(), LR),
        (str(tmp / "unet.pt"), patches, 4), nprocs=4, timeout_s=240,
        mesh=(2, 2))
    return {"ranks": got, "planes": planes, "weights": weights,
            "jstate": jstate, "jmod": jmod, "unet_sd": unet_sd,
            "res_sd": res_sd, "patches": patches, "tmp": tmp}


@pytest.mark.parametrize("S", [2, 4])
def test_halo_matches_slicing_a_padded_plane(runs, S):
    """Each band's halo is the padded plane's rows [j h - d, (j+1) h + d)
    bit for bit, a halo of 31 rows spanning 2 (of 16-row bands) or 4
    neighbours (of 8-row bands), zeros past the edge; the backward adds
    every halo row's cotangent to its owner: the bands' gradients are the
    padded plane's."""
    planes, weights = runs["planes"], runs["weights"][S]
    x = torch.tensor(planes, requires_grad=True)
    h = 32 // S
    want = {}
    for d in ROWS:
        xp = torch.nn.functional.pad(x, (0, 0, d, d))
        ys = [xp[:, :, j * h:j * h + h + 2 * d] for j in range(S)]
        want[d] = [y.detach() for y in ys]
        sum((y * torch.from_numpy(weights[d][:, :, j])).sum()
            for j, y in enumerate(ys)).backward()
    grad = torch.zeros_like(x)
    for r in runs["ranks"]:
        got = r[f"halo_{S}"]
        (lo, hi), (a, b) = got["rows"], got["band"]
        j = a // h
        for d in ROWS:
            assert torch.equal(got["halo"][d], want[d][j][lo:hi]), (S, d, j)
        grad[lo:hi, :, a:b] += got["grad"]
    torch.testing.assert_close(grad, x.grad, rtol=1e-6, atol=1e-6)


def test_unet_2x2_step_matches_the_jax_unsharded_step(runs, one_thread):
    """UNet's SGD step over 2 data x 2 space ranks (every 3x3 conv on a
    halo, the pools and upsamples local, the loss mean and the counts
    over both axes) against the JAX package's one-device step: the row
    and every parameter after the step."""
    step = jmake_train_step(jmake_losses("cross_entropy"), {}, False,
                            donate=False)
    new, row = step(runs["jstate"], _unet_batch())
    want_sd = convert.from_flax({"params": jax.device_get(new.params)})
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["unet"]["row"], np.asarray(row), **TOL)
        for k, v in want_sd.items():
            torch.testing.assert_close(r["unet"]["state_dict"][k], v, **TOL)


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port's one-process 64 px step and eval on the whole batch,
    inside convseg.disabled() (the space step's routing)."""
    model = ResUnetA(NC, img_size=PS, multitasking=True, device="cpu")
    model.load_state_dict(runs["res_sd"])
    state = create_train_state(model, "sgd", LR)
    args = (losses.make_losses("tanimoto"), HEADS, True)
    pipe = make_device_pipeline(NC, 1, device="cpu")
    with one_thread_under_xdist(), convseg.disabled():
        state, row = make_train_step(*args, preprocess=pipe,
                                     device="cpu")(state, _raw())
        eval_row = make_eval_step(*args, preprocess=pipe,
                                  device="cpu")(state, _raw())
    return {"row": row.numpy(), "eval_row": eval_row.numpy(),
            "state_dict": model.state_dict()}


@pytest.fixture(scope="module")
def jax_unsharded():
    """The JAX package's one-device 64 px step (SGD) and eval on the whole
    batch from the same weights, inside its convseg.disabled() (the
    routing of its space step); the parameters and BN buffers after the
    step in the port's names."""
    variables = step_variables()
    tx = jmake_optimizer("sgd", LR)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32),
                         params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), tx=tx,
                         apply_fn=JResUnetA(NC, img_size=PS,
                                            multitasking=True).apply)
    args = (jmake_losses("tanimoto"), HEADS, True)
    pipe = jmake_device_pipeline(NC, 1)
    raw = {k: jnp.asarray(v) for k, v in _raw().items()}
    with jconvseg.disabled():
        new, row = jmake_train_step(*args, preprocess=pipe,
                                    donate=False)(jstate, raw)
        eval_row = jmake_eval_step(*args, preprocess=pipe)(new, raw)
    with one_thread_under_xdist():
        state_dict = convert.from_flax(
            {"params": jax.device_get(new.params),
             "batch_stats": jax.device_get(new.batch_stats)})
    return {"row": np.asarray(row), "eval_row": np.asarray(eval_row),
            "state_dict": state_dict}


def _assert_step_matches(got, want):
    for row in ("row", "eval_row"):
        np.testing.assert_allclose(got[row], want[row], **TOL)
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        torch.testing.assert_close(got["state_dict"][k], v, **TOL)


def test_the_unsharded_step_in_the_scope_matches_jax(unsharded,
                                                     jax_unsharded,
                                                     one_thread):
    """The port's one-process step and eval inside convseg.disabled()
    against the JAX package's inside its own: the row, the eval row, every
    parameter and BN buffer after the step."""
    _assert_step_matches(unsharded, jax_unsharded)


@pytest.mark.parametrize("remat", [False, True])
def test_resuneta_1x2_step_matches_the_unsharded_step(runs, unsharded,
                                                      jax_unsharded, remat,
                                                      one_thread):
    """The multitask d6 at 64 px over 2 bands of 32 rows (d = 31 halos of
    the full band; the middle PSP's levels on 1-row bands gathered),
    Tanimoto's sums over H, W added over space: its row, its eval row
    after the step, every parameter and BN buffer after it, against one
    process of the port and of the JAX package; remat (ranks 2, 3) reruns
    the blocks with the forward's halos. The step gathers the raw bands,
    runs the pipeline (K5, K6) once on the whole planes and no K1-K4."""
    pair = runs["ranks"][2:] if remat else runs["ranks"][:2]
    for r in pair:
        got = r["resuneta"]
        assert got["local_shape"] == (2, 32, PS, 3)
        assert got["counts"] == [0, 0, 1, 1, 0, 0]
        _assert_step_matches(got, unsharded)
        _assert_step_matches(got, jax_unsharded)
    for k, v in pair[0]["resuneta"]["state_dict"].items():
        assert torch.equal(v, pair[1]["resuneta"]["state_dict"][k]), k


def test_make_mesh_2d_lays_out_the_ranks(runs):
    """Rank r of a 2 x 2 mesh is data index r // 2, space index r % 2
    (the reference's device grid, resuneta_tpu/parallel/mesh.py:47-54)."""
    assert [r["coords"] for r in runs["ranks"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_predict_patches_over_a_2x2_group(runs, one_thread):
    """The patches shard over the data axis (a batch of 4: 2 rows a data
    rank, the space ranks the same rows) with the kernels live at every
    forward (whole patches, no height sharded); each rank returns what one
    process returns at the per-rank batch."""
    model = UNet(3, base_filters=8, device="cpu")
    model.load_state_dict(runs["unet_sd"])
    want = predict_patches(make_apply_fn(model, "cpu"), runs["patches"], 2)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["patches"]["out"], want, rtol=1e-6,
                                   atol=1e-6)
        assert r["patches"]["forwards"] == [(False, 2)] * 2


def _fake_mesh(n_data, n_space, data_rank=0, space_rank=0):
    """A SpaceMesh without process groups: enough for what raises before
    any collective."""
    def g(rank, size):
        return DataGroup(None, None, rank, size, torch.device("cpu"), "gloo")
    return SpaceMesh(g(data_rank * n_space + space_rank, n_data * n_space),
                     g(data_rank, n_data), g(space_rank, n_space), n_data,
                     n_space)


def test_refusals():
    """H not divisible by the bands, a band not divisible by the model's
    deepest level (ResUnetA: H by n_space x 32; UNet: by n_space x 16), a
    batch not divisible by the data axis, and the dense routes (K3/K4)
    forced inside the kernels' off scope."""
    mesh = _fake_mesh(2, 2)
    batch = {"image": np.zeros((4, 30, 8, 3), np.float32)}
    with pytest.raises(ValueError, match="height 31"):
        shard_batch_spatial({"image": np.zeros((4, 31, 8, 3))}, mesh)
    with pytest.raises(ValueError, match="not divisible by 2"):
        shard_batch_spatial({"image": np.zeros((3, 32, 8, 3))}, mesh)
    assert shard_batch_spatial(batch, mesh)["image"].shape == (2, 15, 8, 3)
    with axis.data_axis(_fake_mesh(1, 4)):
        with pytest.raises(ValueError, match="ResUnetA over 4 bands"):
            ResUnetA(NC, img_size=PS, device="cpu")(
                torch.zeros(1, 16, PS, 3))
        with pytest.raises(ValueError, match="UNet over 4 bands"):
            UNet(3, base_filters=4, device="cpu")(torch.zeros(1, 8, 32, 3))
    with axis.data_axis(_fake_mesh(1, 2)), convseg.disabled():
        model = ResUnetA(NC, img_size=PS, device="cpu", dense_trunk=True)
        with pytest.raises(ValueError, match="dense_trunk=True"):
            model.train()(torch.zeros(1, 32, PS, 3))
        with pytest.raises(RuntimeError, match="K3"):
            densemm.dense_mm([torch.zeros(1, 4, 4, 8)], torch.zeros(8, 8),
                             torch.zeros(8))
        assert not convseg.available(64, 32, 32)
