"""The port's Amazon workload helpers against the JAX package's, on numpy
inputs made from a seed: the patch grid (host and device), normalize_hsv,
the morphology, the dataset build of data/amazon.py, the device confusion
matrix and the Amazon metrics, the sliding heads of the whole-scene eval
and infer/amazon.py's chain, through a deterministic apply_fn given to
both packages.

Tolerance: none. Every function here is an integer, selection or mask
computation, or float arithmetic done in the same order on both sides, and
is held bit for bit; the one exception, normalize_hsv's norm_type 3 (an
f32 mean and std summed in another order), is held to 1e-6 as
tests/test_torch_infer.py holds the other normalizations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_torch import one_thread  # noqa: F401  (a fixture)
from resuneta_torch import metrics as tmetrics
from resuneta_torch.data import amazon as tamazon
from resuneta_torch.infer import amazon as tinfer
from resuneta_torch.infer import sliding as tsliding
from resuneta_torch.ops import morphology as tmorph
from resuneta_torch.ops import normalize as tnorm
from resuneta_torch.ops import patches as tpatches
from resuneta_tpu import metrics as jmetrics
from resuneta_tpu.data import amazon as jamazon
from resuneta_tpu.infer import amazon as jinfer
from resuneta_tpu.infer import sliding as jsliding
from resuneta_tpu.ops import morphology as jmorph
from resuneta_tpu.ops import normalize as jnorm
from resuneta_tpu.ops import patches as jpatches

pytestmark = pytest.mark.usefixtures("one_thread")


def _same(got, want):
    """Bit for bit, through nested tuples, lists and dicts."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _scene(H=80, W=48, C=4, seed=0):
    """A 5 x 3 tile scene: a float image, a 0/1 reference with blobs, a
    past reference and a valid mask with one invalid corner."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((H, W, C)).astype(np.float32)
    ref = np.zeros((H, W), np.uint8)
    for _ in range(12):
        r0, c0 = rng.integers(0, H - 6), rng.integers(0, W - 6)
        dh, dw = rng.integers(2, 10, 2)
        ref[r0:r0 + dh, c0:c0 + dw] = 1
    past = np.zeros((H, W), np.uint8)
    past[rng.uniform(size=(H, W)) < 0.03] = 1
    valid = np.full((H, W), -1.0, np.float32)
    valid[H - 5:, W - 7:] = 0.0
    return img, ref, past, valid


# ------------------------------------------------------------------ patches

@pytest.mark.parametrize("ps,stride", [(16, 16), (16, 8), (12, 5)])
def test_extract_patches_matches_jax(ps, stride):
    img, ref, _, _ = _scene()
    assert tpatches.num_patches_grid(80, 48, ps, stride) == \
        jpatches.num_patches_grid(80, 48, ps, stride)
    assert tpatches.num_patches_grid(80, 48, ps) == \
        jpatches.num_patches_grid(80, 48, ps)
    got = tpatches.extract_patches(img, ref, ps, stride)
    _same(got, jpatches.extract_patches(img, ref, ps, stride))
    dev = tpatches.extract_patches_device(torch.from_numpy(img), ps, stride)
    want = np.asarray(jpatches.extract_patches_device(jnp.asarray(img), ps,
                                                      stride))
    _same(dev.numpy(), want)
    _same(dev.numpy(), got[0])


@pytest.mark.parametrize("norm_type", [1, 2, 3])
def test_normalize_hsv_matches_jax(norm_type):
    hsv = np.random.default_rng(norm_type).integers(
        0, 256, (2, 8, 8, 3)).astype(np.float32)
    hsv[..., 0] %= 180
    got = tnorm.normalize_hsv(torch.from_numpy(hsv), norm_type).numpy()
    want = np.asarray(jnorm.normalize_hsv(jnp.asarray(hsv), norm_type))
    if norm_type == 3:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        _same(got, want)


# --------------------------------------------------------------- morphology

@pytest.mark.parametrize("radius", [1, 2, 3])
def test_disk_and_dilation_match_jax(radius):
    _same(tmorph.disk(radius), jmorph.disk(radius))
    rng = np.random.default_rng(radius)
    ints = rng.integers(0, 3, (23, 17)).astype(np.int32)
    ints[rng.uniform(size=ints.shape) < 0.8] = 0
    floats = rng.standard_normal((23, 17)).astype(np.float32)
    for a in (ints, floats, ints.astype(np.uint8)):
        _same(tmorph.dilation_disk(a, radius), jmorph.dilation_disk(a, radius))
    for a in (ints, floats):
        got = tmorph.dilation_disk(torch.from_numpy(a), radius).numpy()
        _same(got, np.asarray(jmorph.dilation_disk(jnp.asarray(a), radius)))


def test_mask_no_considered_and_area_opening_match_jax():
    _, ref, past, _ = _scene(seed=1)
    for buffer in (1, 2, 4):
        _same(tmorph.mask_no_considered(ref, buffer, past),
              jmorph.mask_no_considered(ref, buffer, past))
    rng = np.random.default_rng(2)
    levels = rng.integers(0, 4, (40, 36)).astype(np.int32)
    levels[rng.uniform(size=levels.shape) < 0.5] = 0
    for area in (1, 4, 11, 30):
        for conn in (1, 2):
            _same(tmorph.area_opening(levels, area, conn),
                  jmorph.area_opening(levels, area, conn))
    binary = (rng.uniform(size=(40, 36)) < 0.4).astype(np.float64)
    _same(tmorph.area_opening(binary, 5), jmorph.area_opening(binary, 5))


# --------------------------------------------------------- the dataset build

def test_tiles_and_patch_selection_match_jax():
    img, ref, past, valid = _scene(seed=3)
    final = jmorph.mask_no_considered(ref, 2, past)
    _same(tamazon.make_tile_mask(80, 48), jamazon.make_tile_mask(80, 48))
    _same(tamazon.make_tile_mask(81, 50, rows=2, cols=4),
          jamazon.make_tile_mask(81, 50, rows=2, cols=4))
    m = jamazon.make_tile_mask(80, 48)
    for tid in (1, 8, 15):
        assert tamazon.tile_bbox(m, tid) == jamazon.tile_bbox(m, tid)
    tiles = [1, 5, 8, 12, 15]
    for ps, stride in ((8, 8), (8, 4)):
        _same(tamazon.patch_tiles(tiles, m, img, final, ps, stride),
              jamazon.patch_tiles(tiles, m, img, final, ps, stride))
        for pct in (0, 5, 20):
            _same(tamazon.patch_tiles2(tiles, m, img, final, valid, ps,
                                       stride, pct),
                  jamazon.patch_tiles2(tiles, m, img, final, valid, ps,
                                       stride, pct))
    p, r = jamazon.patch_tiles(tiles, m, img, final, 8, 4)
    for pct in (2, 10):
        _same(tamazon.bal_aug_patches(pct, 8, p, r),
              jamazon.bal_aug_patches(pct, 8, p, r))
        _same(tamazon.bal_aug_patches3(pct, 8, p, r),
              jamazon.bal_aug_patches3(pct, 8, p, r))
    _same(tamazon.bal_aug_patches2(5, 8, p[:7], r[:7]),
          jamazon.bal_aug_patches2(5, 8, p[:7], r[:7]))
    with pytest.raises(ValueError, match="no patch reached"):
        tamazon.bal_aug_patches(101, 8, p, r)
    _same(tamazon.data_augmentation(img[:8, :8], final[:8, :8]),
          jamazon.data_augmentation(img[:8, :8], final[:8, :8]))
    _same(tamazon.class_weights_from_counts(final),
          jamazon.class_weights_from_counts(final))
    assert tamazon.patch_tiles3(tiles, m, final) == \
        jamazon.patch_tiles3(tiles, m, final)


def test_strided_and_prediction_extractors_match_jax():
    img, ref, past, valid = _scene(seed=4)
    final = jmorph.mask_no_considered(ref, 2, past).astype(np.float64)
    final[:6, :10] = -1
    for ps, stride, pct in ((16, 8, 5), (16, 16, 1), (10, 7, 20)):
        _same(tamazon.extract_patches_right_region(img, final, valid, ps,
                                                   stride, pct),
              jamazon.extract_patches_right_region(img, final, valid, ps,
                                                   stride, pct))
        _same(tamazon.extract_patches_right_region_prediction(
                  img, final, None, None, ps, stride),
              jamazon.extract_patches_right_region_prediction(
                  img, final, None, None, ps, stride))
    for t in (1, 2):
        src = final if t == 1 else img
        _same(tamazon.patches_with_out_overlap(src, 16, t, final),
              jamazon.patches_with_out_overlap(src, 16, t, final))
    m = jamazon.make_tile_mask(80, 48)
    _same(tamazon.patch_tiles_prediction([1, 6, 11], m, img, final, None, 8,
                                         8),
          jamazon.patch_tiles_prediction([1, 6, 11], m, img, final, None, 8,
                                         8))


# ------------------------------------------------------------------ metrics

def test_device_confusion_matrix_and_amazon_metrics_match_jax():
    rng = np.random.default_rng(5)
    t = rng.integers(0, 3, (4, 16, 16)).astype(np.uint8)
    p = np.where(rng.uniform(size=t.shape) < 0.6, t,
                 rng.integers(0, 3, t.shape)).astype(np.uint8)
    got = tmetrics.confusion_matrix_device(torch.from_numpy(t),
                                           torch.from_numpy(p), 3)
    want = jmetrics.confusion_matrix_device(jnp.asarray(t), jnp.asarray(p), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  jmetrics.confusion_matrix(t, p, range(3)))
    cm2 = jmetrics.confusion_matrix(t.ravel() % 2, p.ravel() % 2)
    assert tmetrics.alarm_area(cm2) == jmetrics.alarm_area(cm2)
    prob = rng.uniform(size=(20, 24))
    refm = (rng.uniform(size=(20, 24)) < 0.3).astype(np.int64)
    mask = (rng.uniform(size=(20, 24)) < 0.8).astype(np.int64)
    ths = [0.1, 0.35, 0.5, 0.9]
    _same(tmetrics.threshold_sweep_curves(ths, prob, refm, mask),
          jmetrics.threshold_sweep_curves(ths, prob, refm, mask))


# ---------------------------------------------------- the whole-scene eval

_M = np.random.default_rng(6).standard_normal((4, 3)).astype(np.float32)


def _toy_torch(x):
    """A per-pixel 'model' on every band: the softmax of a fixed linear map
    of the pixel, as tensors."""
    return {"seg": torch.softmax(torch.as_tensor(x).float() @
                                 torch.from_numpy(_M), dim=-1)}


def _toy_jax(x):
    """The same outputs, as JAX arrays."""
    return {"seg": jnp.asarray(_toy_torch(np.asarray(x))["seg"].numpy())}


def test_sliding_heads_match_jax():
    seg = _toy_torch(_scene()[0][:32, :32])["seg"]
    jseg = jnp.asarray(seg.numpy())
    for arg, jarg in ((seg, jseg), ({"seg": seg}, {"seg": jseg})):
        got = tsliding.seg_ids_prob1(arg)
        want = jsliding.seg_ids_prob1(jarg)
        _same({k: v.numpy() for k, v in got.items()},
              {k: np.asarray(v) for k, v in want.items()})
        _same(tsliding.seg_prob1_f16(arg).numpy(),
              np.asarray(jsliding.seg_prob1_f16(jarg)))


@pytest.mark.parametrize("full_probs", [False, True], ids=["light", "full"])
def test_prediction_chain_matches_jax(full_probs):
    """prediction, output_prediction_FC and prediction2, then the
    threshold sweep and the colour map, on a 64 x 48 scene of 16 px
    patches with a 3-patch tail batch."""
    img, ref, past, _ = _scene(64, 48, seed=7)
    final = jmorph.mask_no_considered(ref, 2, past)
    mask_ts = np.zeros((64, 48), np.float32)
    mask_ts[16:, :32] = 1
    kw = dict(patch_size=16, area=4, batch_size=5, full_probs=full_probs)
    got = tinfer.prediction(_toy_torch, img, ref, final, mask_ts, **kw)
    want = jinfer.prediction(_toy_jax, img, ref, final, mask_ts, **kw)
    _same(got[:6], want[:6])
    got_fc = tinfer.output_prediction_FC(_toy_torch, img, final, 16, 5,
                                         full_probs=full_probs)
    want_fc = jinfer.output_prediction_FC(_toy_jax, img, final, 16, 5,
                                          full_probs=full_probs)
    _same(got_fc[0], want_fc[0])
    # prediction2's reference may hold -1 (outside the footprint), so it is
    # signed (numpy 2.0 with torch loaded crashes comparing a strided uint8
    # view to -1)
    ref_f = ref.astype(np.float64)
    got2 = tinfer.prediction2(_toy_torch, img, ref_f, final, mask_ts, 16, 4,
                              5, full_probs=full_probs)
    want2 = jinfer.prediction2(_toy_jax, img, ref_f, final, mask_ts, 16, 4,
                               5, full_probs=full_probs)
    _same(got2[:3], want2[:3])
    bad = ref_f.copy()
    bad[0, 0] = -1
    with pytest.raises(ValueError, match="fully valid"):
        tinfer.prediction2(_toy_torch, img, bad, final, mask_ts, 16, 4, 5)

    prob, ref_rec, ref_clip, clip = got[2], got[3], got[4], got[5]
    ths = np.round(np.arange(0.05, 1.0, 0.05), 3)
    _same(tinfer.matrics_AA_recall(ths, prob, ref_clip, clip, 4),
          jinfer.matrics_AA_recall(ths, prob, ref_clip, clip, 4))
    cmap = tinfer.color_map(prob, ref_rec, ref_clip, clip, 0.5)
    _same(cmap, jinfer.color_map(prob, ref_rec, ref_clip, clip, 0.5))
    _same(tinfer.rgb_image(cmap), jinfer.rgb_image(cmap))
