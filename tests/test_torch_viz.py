"""The test CLI's multitask visualisation (resuneta_torch/cli/test_isprs.py
`multitask_viz_panels`, `_save_multitask_viz`; resuneta_tpu/cli/
test_isprs.py:168-230) and `ops.colorspace.hsv_to_rgb_cv2` against the JAX
package on the CPU.

- hsv_to_rgb_cv2 on every cv2 hue 0..179 with S and V in steps of 5:
  within 1e-3 of JAX's (f32 arithmetic in the same order; XLA may contract
  a multiply-add);
- the panel arrays of 64 px patches against what JAX's CLI computes inline
  from its own functions: the one-hot, boundary and distance planes bit
  for bit, the RGB render within 1 of 255, the difference map within 1e-5;
- the CLI at 64 px writes exactly pred{0,1}_classes.jpg and
  pred{0,1}_color.jpg under --max_viz_patches 2, and without matplotlib
  writes none, says so, and still computes the panels."""

import builtins
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch.cli.test_isprs import main, multitask_viz_panels
from resuneta_torch.data import isprs as tisprs
from resuneta_torch.models import ResUnetA
from resuneta_torch.ops import boundary, colorspace, distance
from resuneta_torch.train.checkpoint import save_variables
from resuneta_tpu.ops import colorspace as jcolorspace
from resuneta_tpu.ops.boundary import get_boundary_label
from resuneta_tpu.ops.distance import get_distance_label
from test_torch_labels import voronoi_ids
from util_synth import synth_scene
from util_torch import one_thread  # noqa: F401  (a fixture)

NC = 5


def test_hsv_to_rgb_matches_jax_on_the_cv2_grid():
    h, s, v = np.meshgrid(np.arange(180), np.arange(0, 256, 5),
                          np.arange(0, 256, 5), indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    got = colorspace.hsv_to_rgb_cv2(torch.from_numpy(hsv)).numpy()
    want = np.asarray(jcolorspace.hsv_to_rgb_cv2(jnp.asarray(hsv)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # primaries and greys land where cv2 puts them
    edges = torch.tensor([[0, 255, 255], [60, 255, 255], [120, 255, 255],
                          [0, 0, 200]], dtype=torch.uint8)
    np.testing.assert_allclose(
        colorspace.hsv_to_rgb_cv2(edges).numpy(),
        [[255, 0, 0], [0, 255, 0], [0, 0, 255], [200, 200, 200]], atol=1e-3)


# the JAX CLI's label function (test_isprs.py:180), compiled once
_GEN = jax.jit(lambda oh: (get_boundary_label(oh), get_distance_label(oh)))


def _jax_panels(patch, ref_ids, color):
    """What resuneta_tpu/cli/test_isprs.py:180-225 computes for a patch,
    from the JAX package's functions."""
    img = (patch * 255).clip(0, 255).astype(np.uint8)
    onehot = np.eye(NC, dtype=np.float32)[ref_ids.astype(np.int64) % NC]
    bound, dist = (np.asarray(a) for a in _GEN(jnp.asarray(onehot)))
    hsv = (color * np.array([179, 255, 255])).astype(np.uint8)
    rgb = np.asarray(jcolorspace.hsv_to_rgb_cv2(jnp.asarray(hsv))).clip(
        0, 255).astype(np.uint8)
    diff = np.mean(hsv.astype(np.float32) - np.asarray(
        jcolorspace.rgb_to_hsv_cv2(jnp.asarray(img))), axis=-1)
    rng = diff.max() - diff.min()
    diff = 2 * (diff - diff.min()) / (rng if rng else 1.0) - 1.0
    return {"img": img, "seg_ref": onehot, "bound_ref": bound,
            "dist_ref": dist, "hsv": hsv, "rgb": rgb, "diff": diff}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panels_match_jax(seed):
    rng = np.random.default_rng(seed)
    patch = rng.uniform(-0.1, 1.1, (64, 64, 3)).astype(np.float32)
    ids = voronoi_ids(1, 64, NC, seed)[0]
    if seed == 2:
        ids[:] = 3                       # one class: empty planes elsewhere
    color = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    calls = (boundary.CALLS, distance.CALLS)
    got = multitask_viz_panels(patch, ids, {"color": color}, NC, "cpu")
    assert (boundary.CALLS - calls[0], distance.CALLS - calls[1]) == (1, 1)
    want = _jax_panels(patch, ids, color)
    assert sorted(got) == sorted(want)
    for k in ("img", "seg_ref", "bound_ref", "dist_ref", "hsv"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["rgb"].dtype == np.uint8
    assert np.abs(got["rgb"].astype(int) - want["rgb"]).max() <= 1
    np.testing.assert_allclose(got["diff"], want["diff"], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A 128 x 128 scene (4 patches of 64 px) and seeded d6 weights."""
    root = tmp_path_factory.mktemp("viz")
    image, ids = synth_scene(128, 128, seed=3)
    np.save(root / "Image_Test.npy", image.transpose(2, 0, 1))
    np.save(root / "Reference_Test.npy",
            tisprs.class_ids_to_rgb(ids).transpose(2, 0, 1))
    model = ResUnetA(NC, img_size=64, generator=torch.Generator().manual_seed(
        4), device="cpu")
    save_variables(root / "weights.pt", model)
    return root


def _run(root, out):
    return main(["--model_path", str(root / "weights.pt"), "--dataset_path",
                 str(root), "-ps", "64", "--use_multitasking",
                 "--output_path", str(out), "--batch_size", "4",
                 "--max_viz_patches", "2", "--device", "cpu"])


@pytest.mark.usefixtures("one_thread")
def test_cli_writes_the_figures_of_max_viz_patches(cli_data, tmp_path,
                                                   capsys):
    calls = (boundary.CALLS, distance.CALLS)
    _run(cli_data, tmp_path / "out")
    text = capsys.readouterr().out
    assert "matplotlib" not in text and "not written" not in text
    assert sorted(os.listdir(tmp_path / "out")) == [
        "pred0_classes.jpg", "pred0_color.jpg", "pred1_classes.jpg",
        "pred1_color.jpg", "pred_seg_reconstructed.jpeg"]
    assert (boundary.CALLS - calls[0], distance.CALLS - calls[1]) == (2, 2)


@pytest.mark.usefixtures("one_thread")
def test_cli_without_matplotlib_says_so(cli_data, tmp_path, capsys,
                                        monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    calls = (boundary.CALLS, distance.CALLS)
    _run(cli_data, tmp_path / "out")
    text = capsys.readouterr().out
    assert "matplotlib cannot be imported: the multitask figures are not " \
        "written" in text
    assert sorted(os.listdir(tmp_path / "out")) == [
        "pred_seg_reconstructed.jpeg"]
    assert (boundary.CALLS - calls[0], distance.CALLS - calls[1]) == (2, 2)
