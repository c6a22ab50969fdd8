"""The row-tiled label kernels of the PyTorch port against the JAX package
on the CPU: the row-tiled EDT (K7's design, which the port runs for every
plane; resuneta_torch/ops/distance.py) and K8 (the row-tiled Canny,
resuneta_torch/ops/boundary.py), whose plain versions repeat the kernels'
band decomposition, against the Pallas kernels they replace (interpret
mode), the XLA functions (resuneta_tpu/ops/distance.py, boundary.py) and
the port's whole-plane plain versions, bit for bit; the routing by plane
size; and the label pipeline at a patch size whose boundary labels take
K8."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resuneta_torch.data import make_device_pipeline
from resuneta_torch.ops import boundary, distance
from resuneta_tpu.ops import boundary as jboundary
from resuneta_tpu.ops import distance as jdistance
from resuneta_tpu.ops.pallas import canny as jcanny
from resuneta_tpu.ops.pallas import jfa as jjfa
from util_torch import one_thread  # noqa: F401  (a fixture)

# bit-for-bit comparisons of elementwise and min/max results: the thread
# count moves nothing they check (see one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")


def voronoi_ids(n, shape, classes, rng, sites=12):
    """(n, H, W) class ids of blob regions: each pixel takes the class of
    its nearest random site."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    out = np.empty((n,) + shape, np.int64)
    for k in range(n):
        pts = rng.uniform(0, 1, (sites, 2)) * shape
        cls = rng.integers(0, classes, sites)
        d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
        out[k] = cls[np.argmin(d2, axis=-1)]
    return out


def planes(kind, shape, seed):
    """(P, H, W) int32 binary planes of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "voronoi":
        ids = voronoi_ids(2, shape, 4, rng)
        p = np.eye(4, dtype=np.int32)[ids].transpose(0, 3, 1, 2)
        return np.ascontiguousarray(p.reshape((-1,) + shape))
    if kind == "noise":
        return (rng.random((3,) + shape) < 0.5).astype(np.int32)
    if kind == "sparse":      # isolated pixels: corners in every direction
        return (rng.random((2,) + shape) < 0.03).astype(np.int32)
    return np.stack([np.zeros(shape, np.int32),
                     np.ones(shape, np.int32)])      # all-zero, all-one


KINDS = ["voronoi", "noise", "sparse", "constant"]


def _all_kinds(shape):
    """Every kind's planes in one array, and each kind's slice of it."""
    parts = [planes(kind, shape, seed=sum(shape)) for kind in KINDS]
    bounds = np.cumsum([0] + [len(p) for p in parts])
    return np.concatenate(parts), {
        kind: slice(bounds[k], bounds[k + 1]) for k, kind in enumerate(KINDS)}


def _counts():
    return (distance.CALLS, distance.LAUNCHES,
            boundary.CALLS, boundary.LAUNCHES, boundary.TILED_LAUNCHES)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


# ------------------------------------------------------------------ K7

@functools.cache
def _k7_references(shape):
    """The JAX row-tiled kernel (tile 16, interpret), the XLA function and
    the port's whole-plane plain version, one call each."""
    allp, kinds = _all_kinds(shape)
    tiled = jjfa.distance_transform_edt_pallas_tiled(jnp.asarray(allp),
                                                     tile=16, interpret=True)
    xla = jax.vmap(jdistance.distance_transform_edt)(jnp.asarray(allp))
    whole = distance.distance_transform_edt_reference(torch.from_numpy(allp))
    return allp, kinds, np.asarray(tiled), np.asarray(xla), whole.numpy()


@pytest.mark.parametrize("shape", [(64, 128), (128, 128)])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_k7_plain_is_bit_identical(shape, tile, kind):
    """K7's plain version, forced through the wrapper's `tile`: one call on
    the CPU, no launch; equal arrays against the JAX row-tiled kernel, the
    XLA function and the whole-plane plain version."""
    allp, kinds, tiled, xla, whole = _k7_references(shape)
    sl = kinds[kind]
    before = _counts()
    got = distance.distance_transform_edt(torch.from_numpy(allp[sl]),
                                          tile=tile).numpy()
    assert _delta(before) == (1, 0, 0, 0, 0)
    assert got.dtype == np.float32 and got.shape == allp[sl].shape
    np.testing.assert_array_equal(got, tiled[sl])
    np.testing.assert_array_equal(got, xla[sl])
    np.testing.assert_array_equal(got, whole[sl])


@pytest.mark.parametrize("H", range(8, 16))
def test_k7_short_planes(H):
    """H = 8..15, where the steps reach past the plane's height and the
    row bands collapse: at every tile, including bands cut short by the
    plane's edge, equal to the whole-plane plain version; at H = 8 and 15
    also to the XLA function (the JAX row-tiled kernel reads out of bounds
    at these heights: its aligned-floor fetch assumes a halo of 8 rows)."""
    allp, _ = _all_kinds((H, 24))
    t = torch.from_numpy(allp)
    whole = distance.distance_transform_edt_reference(t)
    for tile in (1, 3, 8, 16):
        got = distance.distance_transform_edt_tiled_reference(t, tile)
        assert torch.equal(got, whole), tile
    if H in (8, 15):
        xla = jax.vmap(jdistance.distance_transform_edt)(jnp.asarray(allp))
        np.testing.assert_array_equal(whole.numpy(), np.asarray(xla))


def test_k7_schedule_drops_only_passes_with_no_candidate():
    """The kernel's schedule is K7's, K5's without the steps s >= max(H, W):
    12 passes at 1024^2 (K5 would run 13), 10 at 256^2; its default band
    rows are the fastest measured on an H100: 8 at W = 256, 4 at 512, 2 at
    1024."""
    assert distance.tiled_steps(1024, 1024) == [1] + [2 ** k for k in
                                                      range(9, -1, -1)] + [1]
    assert len(distance.jfa_steps(1024, 1024)) == 13
    assert len(distance.tiled_steps(256, 256)) == 10
    assert distance.tiled_steps(8, 24) == [1, 16, 8, 4, 2, 1, 1]
    assert [distance.default_tile(w) for w in (128, 256, 512, 1024)] == [
        16, 8, 4, 2]


# ------------------------------------------------------------------ K8

@functools.cache
def _k8_references(shape):
    """The JAX Pallas kernel (interpret; row-tiled with tile 64 at 256x640,
    the smallest shape it tiles, whole-plane at 128^2), the XLA functions
    and the port's whole-plane plain version, one call each."""
    allp, kinds = _all_kinds(shape)
    if shape == (128, 128):
        allp = np.concatenate([allp, _border_planes(128)])
        kinds["border"] = slice(len(allp) - 6, len(allp))
    pallas = jcanny.boundary_label_pallas(jnp.asarray(allp), interpret=True)
    xla = jax.vmap(jboundary.cross_dilate)(
        jax.vmap(jboundary.canny_binary)(jnp.asarray(allp)))
    whole = boundary.boundary_label_reference(torch.from_numpy(allp))
    return allp, kinds, np.asarray(pallas), np.asarray(xla), whole.numpy()


def _border_planes(size):
    """Blobs that touch the plane's edges near the boundary of two 64-row
    bands, inside each band's 35-row halo: discs cut by the left and right
    edges, bars down from the top and up from the bottom edge, and an
    L-shape along two edges."""
    yy, xx = np.mgrid[:size, :size]
    out = [((yy - 60) ** 2 + xx ** 2 < 20 ** 2),
           ((yy - 70) ** 2 + (xx - size + 1) ** 2 < 15 ** 2),
           (yy < 66) & (xx > 30) & (xx < 50),
           (yy > 62) & (xx > 70) & (xx < 90),
           ((xx < 5) | (yy > size - 4)) & (yy > 40),
           ((yy - 64) ** 2 + (xx - 64) ** 2 < 30 ** 2) | (yy == 0)]
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("tile", [None, 64, 37])
@pytest.mark.parametrize("kind", KINDS)
def test_k8_plain_is_bit_identical(tile, kind):
    """256x640 planes are above the whole-plane limit, so the wrapper
    routes them to K8 (its default tile 128, or the one given): one call,
    no launch; equal arrays against the JAX row-tiled kernel, the XLA
    functions and the whole-plane plain version."""
    allp, kinds, pallas, xla, whole = _k8_references((256, 640))
    sl = kinds[kind]
    before = _counts()
    got = boundary.boundary_label(torch.from_numpy(allp[sl]),
                                  tile=tile).numpy()
    assert _delta(before) == (0, 0, 1, 0, 0)
    assert got.dtype == np.float32 and got.shape == allp[sl].shape
    np.testing.assert_array_equal(got, pallas[sl])
    np.testing.assert_array_equal(got, xla[sl])
    np.testing.assert_array_equal(got, whole[sl])
    if kind == "constant":
        assert not got.any()


@pytest.mark.parametrize("kind", KINDS + ["border"])
def test_k8_forced_on_small_planes(kind):
    """128^2 planes in two bands of 64 rows (and in bands of 20, 100 and
    200 rows) against the whole-plane Pallas kernel (interpret), the XLA
    functions and the whole-plane plain version; blobs at the plane's
    edges inside the bands' halos."""
    allp, kinds, pallas, xla, whole = _k8_references((128, 128))
    sl = kinds[kind]
    t = torch.from_numpy(allp[sl])
    for tile in (64, 20, 100, 200):
        got = boundary.boundary_label(t, tile=tile).numpy()
        np.testing.assert_array_equal(got, pallas[sl], err_msg=str(tile))
        np.testing.assert_array_equal(got, xla[sl], err_msg=str(tile))
        np.testing.assert_array_equal(got, whole[sl], err_msg=str(tile))
    if kind == "border":
        assert whole[sl].any(axis=(1, 2)).all()


def test_k8_default_tile_fits_shared_memory():
    """128 rows where the window of tile + 70 rows fits 227 KB: at 512^2
    and 1024^2; halved for wider planes; none above W = 3,273."""
    assert boundary.default_tile(512, 512) == 128
    assert boundary.default_tile(1024, 1024) == 128
    assert boundary.default_tile(2048, 2048) == 32
    assert boundary.default_tile(64, 3000) == 128     # the window is H rows
    assert boundary.default_tile(1024, 3300) == 0


# -------------------------------------------------------------- routing

def _spy(monkeypatch, mod, name):
    calls = []
    real = getattr(mod, name)

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(mod, name, spy)
    return calls


def test_cpu_routes_large_planes_to_the_tiled_plain_versions(monkeypatch):
    """A 512^2 plane set goes through K8's tiled plain version and an 800^2
    set through K7's: one wrapper call each, no launch, equal to the
    whole-plane plain versions."""
    rng = np.random.default_rng(5)
    ids = voronoi_ids(1, (512, 512), 3, rng)
    p512 = torch.from_numpy(np.ascontiguousarray(
        np.eye(3, dtype=np.int32)[ids].transpose(0, 3, 1, 2)[0]))
    tiled = _spy(monkeypatch, boundary, "boundary_label_tiled_reference")
    before = _counts()
    got = boundary.boundary_label(p512)
    assert _delta(before) == (0, 0, 1, 0, 0)
    assert tiled == [(3, 512, 512)]
    assert torch.equal(got, boundary.boundary_label_reference(p512))

    p800 = torch.from_numpy(np.stack([
        voronoi_ids(1, (800, 800), 2, rng)[0], (rng.random((800, 800)) < 0.001)
    ]).astype(np.int32))
    tiled = _spy(monkeypatch, distance, "distance_transform_edt_tiled_reference")
    before = _counts()
    got = distance.distance_transform_edt(p800)
    assert _delta(before) == (1, 0, 0, 0, 0)
    assert tiled == [(2, 800, 800)]
    assert torch.equal(got, distance.distance_transform_edt_reference(p800))


@pytest.mark.parametrize("op", ["k7", "k8"])
def test_routing_thresholds(monkeypatch, op):
    """The whole-plane Canny kernel takes planes up to 384^2 (K6), as the
    reference's pipeline routes; one row more, or a `tile`, takes K8. The
    EDT has no threshold: every plane takes the row-tiled version, whose
    plain version the CPU runs."""
    mod, limit, names = (
        (distance, 768, ("distance_transform_edt_reference",
                         "distance_transform_edt_tiled_reference"))
        if op == "k7" else
        (boundary, 384, ("boundary_label_reference",
                         "boundary_label_tiled_reference")))
    taken = []
    for k, name in enumerate(names):
        monkeypatch.setattr(mod, name, lambda p, *a, k=k: taken.append(k))
    fn = (distance.distance_transform_edt if op == "k7"
          else boundary.boundary_label)
    fn(torch.zeros((1, limit, limit), dtype=torch.int32))
    fn(torch.zeros((1, limit + 1, limit), dtype=torch.int32))
    fn(torch.zeros((1, 16, 16), dtype=torch.int32), tile=8)
    assert taken == ([1, 1, 1] if op == "k7" else [0, 1, 1])


@pytest.mark.parametrize("bad", ["dtype", "shape", "tile0", "too_wide"])
def test_tiled_wrappers_reject_what_the_kernels_do_not_take(bad):
    """On the CPU as on the card: non-int32 or non-3-D planes, a tile below
    1, and bands whose shared-memory staging would pass 227 KB (K8: a
    window of W = 4000 bytes a row; K7: 12 * 32 * 1024 bytes)."""
    p = torch.zeros(2, 16, 16, dtype=torch.int32)
    cases = {"dtype": [(fn, p.float(), 4) for fn in
                       (distance.distance_transform_edt,
                        boundary.boundary_label)],
             "shape": [(fn, p[0], 4) for fn in
                       (distance.distance_transform_edt,
                        boundary.boundary_label)],
             "tile0": [(fn, p, 0) for fn in
                       (distance.distance_transform_edt,
                        boundary.boundary_label)],
             "too_wide": [(boundary.boundary_label,
                           torch.zeros(1, 400, 4000, dtype=torch.int32), None),
                          (distance.distance_transform_edt,
                           torch.zeros(1, 64, 1024, dtype=torch.int32), 32)]}
    before = _counts()
    for fn, x, tile in cases[bad]:
        with pytest.raises(ValueError):
            fn(x, tile=tile)
    assert _delta(before) == (0,) * 5


# -------------------------------------------------------------- pipeline

def test_device_pipeline_hands_large_planes_to_k8_in_one_call():
    """bs 2 at 392 px: the pipeline gives all 10 class planes of 392^2,
    above the whole-plane Canny limit, to one K8 call and to one EDT call;
    its labels equal the whole-plane plain versions of the same one-hot
    planes. (The JAX package's CPU pipeline is no reference at this size:
    its XLA EDT misplaces a shifted seed plane when a JFA step passes the
    plane's side, which only a side that is not a power of two reaches;
    its Pallas kernels agree with the port there.)"""
    rng = np.random.default_rng(9)
    raw = {"image_u8": rng.integers(0, 256, (2, 392, 392, 3), dtype=np.uint8),
           "label_ids": voronoi_ids(2, (392, 392), 5, rng).astype(np.uint8),
           "aug": np.array([2, 3], np.int32)}
    before = _counts()
    got = make_device_pipeline(5, norm_type=1, device="cpu")(raw)
    assert _delta(before) == (1, 0, 1, 0, 0)
    p = got["seg"].movedim(-1, 1).reshape(10, 392, 392).to(torch.int32)
    bound = boundary.boundary_label_reference(p.contiguous())
    dist = distance.minmax_norm01(
        distance.distance_transform_edt_reference(p.contiguous()))
    assert torch.equal(got["bound"], bound.reshape(2, 5, 392, 392).movedim(
        1, -1))
    assert torch.equal(got["dist"], dist.reshape(2, 5, 392, 392).movedim(
        1, -1))
    assert got["bound"].sum() > 0 and got["dist"].max() == 1.0
