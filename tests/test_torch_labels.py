"""The label side of the PyTorch port's train pipeline against the JAX
package on the CPU: K5 (distance, resuneta_torch/ops/distance.py) and K6
(boundary, resuneta_torch/ops/boundary.py) plain versions against the Pallas
kernels they replace (interpret mode) and the XLA functions
(resuneta_tpu/ops/distance.py, boundary.py), bit for bit; the HSV colour
label bit for bit; the 5 augmentation variants; and make_device_pipeline
against the JAX pipeline on one batch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch.data import (make_device_pipeline,
                                 make_label_head_pipeline)
from resuneta_torch.ops import augment, boundary, colorspace, distance
from resuneta_tpu.data import make_device_pipeline as jmake_device_pipeline
from resuneta_tpu.ops import augment as jaugment
from resuneta_tpu.ops import boundary as jboundary
from resuneta_tpu.ops import colorspace as jcolorspace
from resuneta_tpu.ops import distance as jdistance
from resuneta_tpu.ops.pallas import canny as jcanny
from resuneta_tpu.ops.pallas import jfa as jjfa


def voronoi_ids(n, size, classes, seed, sites=12):
    """(n, size, size) class ids of blob regions: each pixel takes the class
    of its nearest random site."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = np.empty((n, size, size), np.int64)
    for k in range(n):
        pts = rng.uniform(0, size, (sites, 2))
        cls = rng.integers(0, classes, sites)
        d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
        out[k] = cls[np.argmin(d2, axis=-1)]
    return out


def planes(kind, size, seed=0):
    """(P, size, size) int32 binary planes of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "voronoi":
        ids = voronoi_ids(2, size, 4, seed)
        p = np.eye(4, dtype=np.int32)[ids].transpose(0, 3, 1, 2)
        return np.ascontiguousarray(p.reshape(-1, size, size))
    if kind == "noise":
        return (rng.random((3, size, size)) < 0.5).astype(np.int32)
    if kind == "sparse":      # isolated pixels: corners in every direction
        return (rng.random((2, size, size)) < 0.03).astype(np.int32)
    return np.stack([np.zeros((size, size), np.int32),
                     np.ones((size, size), np.int32)])   # all-zero, all-one


KINDS = ["voronoi", "noise", "sparse", "constant"]


@functools.cache
def _label_results(op, size):
    """Every kind's planes through the port's plain version, the Pallas
    kernel (interpret) and the XLA function, in one call each (one compile
    per size), split back by kind."""
    parts = [planes(kind, size, seed=size) for kind in KINDS]
    allp = np.concatenate(parts)
    if op == "k5":
        calls, launches = distance.CALLS, distance.LAUNCHES
        got = distance.distance_transform_edt(torch.from_numpy(allp))
        counted = (distance.CALLS - calls, distance.LAUNCHES - launches)
        pallas = jjfa.distance_transform_edt_pallas(jnp.asarray(allp),
                                                    interpret=True)
        xla = jax.vmap(jdistance.distance_transform_edt)(jnp.asarray(allp))
    else:
        calls, launches = boundary.CALLS, boundary.LAUNCHES
        got = boundary.boundary_label(torch.from_numpy(allp))
        counted = (boundary.CALLS - calls, boundary.LAUNCHES - launches)
        pallas = jcanny.boundary_label_pallas(jnp.asarray(allp),
                                              interpret=True)
        xla = jax.vmap(jboundary.cross_dilate)(
            jax.vmap(jboundary.canny_binary)(jnp.asarray(allp)))
    bounds = np.cumsum([0] + [len(p) for p in parts])
    split = {}
    for k, kind in enumerate(KINDS):
        sl = slice(bounds[k], bounds[k + 1])
        split[kind] = (got.numpy()[sl], np.asarray(pallas)[sl],
                       np.asarray(xla)[sl])
    return split, counted


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["k5", "k6"])
def test_label_plain_is_bit_identical(op, kind, size):
    """K5 (EDT) and K6 (Canny + cross dilation) plain versions against the
    Pallas kernel in interpret mode and the XLA function: equal arrays.
    One wrapper call on the CPU: counted as a call, not a launch."""
    split, counted = _label_results(op, size)
    got, pallas, xla = split[kind]
    assert counted == (1, 0)
    assert got.dtype == np.float32 and got.shape == pallas.shape
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    if op == "k6" and kind == "constant":
        assert not got.any()


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_label_wrappers_reject_what_the_kernels_do_not_take(bad):
    p = torch.zeros(2, 8, 8, dtype=torch.int32)
    p = p.float() if bad == "dtype" else p[0]
    for fn in (distance.distance_transform_edt, boundary.boundary_label):
        with pytest.raises(ValueError):
            fn(p)


def test_hsv_is_bit_identical_to_cv2_emulation():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    img[0, :10] = 0                               # black
    img[1, :256] = np.arange(256)[:, None]        # every grey level
    img[2, :6] = [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
                  [0, 255, 255], [255, 0, 255]]   # hue branch edges
    got = colorspace.rgb_to_hsv_cv2(torch.from_numpy(img)).numpy()
    want = np.asarray(jcolorspace.rgb_to_hsv_cv2(jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)
    for nt in (1, 2):
        np.testing.assert_array_equal(
            colorspace.hsv_color_label(torch.from_numpy(img[None]), nt)[0]
            .numpy(), np.asarray(jcolorspace.hsv_color_label(
                jnp.asarray(img), nt)))


def test_augment_variants_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    idx = np.array([0, 1, 2, 3, 4])
    got = augment.augment_batch(torch.from_numpy(x), idx).numpy()
    for k in range(5):
        want = np.asarray(jaugment.augment_by_index(jnp.asarray(x[k]), k))
        np.testing.assert_array_equal(got[k], want)
    np.testing.assert_array_equal(got[1], np.rot90(x[1]))      # ccw


def _raw_batch(n=2, size=64, seed=3):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (n, size, size, 3),
                                     dtype=np.uint8),
            "label_ids": voronoi_ids(n, size, 5, seed).astype(np.uint8),
            "aug": np.array([1, 4][:n], np.int32)}


def test_device_pipeline_matches_jax():
    """bs 2, 64 px: labels bit for bit, the image within 1e-6."""
    raw = _raw_batch()
    got = make_device_pipeline(5, norm_type=1, device="cpu")(raw)
    want = jax.jit(jmake_device_pipeline(5, norm_type=1))(
        {k: jnp.asarray(v) for k, v in raw.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == np.float32, k
        if k == "image":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["bound"].sum() > 0 and got["dist"].max() == 1.0


def test_label_head_pipeline_adds_bound_and_dist():
    """make_label_head_pipeline (the Amazon multitask path): the boundary
    and distance labels of the one-hot 'seg', next to what came in; a
    batch that already has them passes through."""
    raw = _raw_batch(size=32)
    seg = np.eye(5, dtype=np.float32)[raw["label_ids"]]
    batch = {"image": raw["image_u8"].astype(np.float32) / 255.0, "seg": seg}
    pipe = make_label_head_pipeline(device="cpu")
    out = pipe(batch)
    assert sorted(out) == ["bound", "dist", "image", "seg"]
    t = torch.from_numpy(seg)
    assert torch.equal(out["bound"], boundary.get_boundary_label(t))
    assert torch.equal(out["dist"], distance.get_distance_label(t))
    again = pipe(out)
    assert all(torch.equal(again[k], out[k]) for k in out)
