"""The port's training runtime under the train CLI against the JAX package
on the CPU: the datasets (resuneta_torch/data/dataset.py), the native row
gather and batch loader (data/native_loader.py), the train/validation
split (data/split.py) against scikit-learn, the UNet baseline
(models/unet.py) through convert.from_flax, and the checkpoints
(train/checkpoint.py).

The datasets are numpy code on both sides: every batch is held bit for bit
(the bilinear resize too, though f32 1e-6 would do, since both run the same
float32 numpy operations in the same order). The UNet forward is held at
f32 1e-5 absolute on softmax outputs in [0, 1] (XLA's and PyTorch's CPU
convolutions sum in different orders). Checkpoints round-trip bit for
bit."""

import json
import os
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from resuneta_torch import convert
from resuneta_torch.data import dataset as tds
from resuneta_torch.data import native_loader as tnl
from resuneta_torch.data.split import train_test_split
from resuneta_torch.models import UNet
from resuneta_torch.models.norm import BatchNorm
from resuneta_torch.models.resuneta import Conv
from resuneta_torch.train import checkpoint, create_train_state
from resuneta_tpu.data import dataset as jds
from resuneta_tpu.data import native_loader as jnl
from resuneta_tpu.models import UNet as JUNet
from test_torch_model import flax_variables
from util_synth import synth_patches
from util_torch import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- datasets

@pytest.mark.parametrize("data_aug", [True, False])
def test_write_packed_dataset_matches_jax(tmp_path, data_aug):
    images, ids = synth_patches(3, 16, 3, 5, seed=1)
    extra = {"source": "synthetic", "stride": 8}
    want = jds.write_packed_dataset(str(tmp_path / "j"), images, ids, 5,
                                    norm_type=2, data_aug=data_aug,
                                    extra_meta=extra)
    got = tds.write_packed_dataset(str(tmp_path / "t"), images, ids, 5,
                                   norm_type=2, data_aug=data_aug,
                                   extra_meta=extra)
    assert got == want
    for name in ("images.npy", "labels.npy", tds.MANIFEST):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert tds.is_packed(str(tmp_path / "t"))
    assert not tds.is_packed(str(tmp_path))
    assert (tds.MANIFEST, tds.AUG_FACTOR) == (jds.MANIFEST, jds.AUG_FACTOR)


@pytest.mark.parametrize("data_aug", [True, False])
def test_packed_batches_match_jax(tmp_path, data_aug):
    """The same positions of the same subset: uint8 images and ids, int32
    augmentation variants (sample k = patch k // 5, variant k % 5)."""
    images, ids = synth_patches(7, 16, 3, 5, seed=2)
    root = str(tmp_path)
    jds.write_packed_dataset(root, images, ids, 5, data_aug=data_aug)
    jfull, tfull = jds.PackedDataset(root), tds.PackedDataset(root)
    assert len(tfull) == len(jfull) == 7 * (5 if data_aug else 1)
    rng = np.random.default_rng(3)
    sub = rng.permutation(len(jfull))[:len(jfull) - 2]
    jsub, tsub = jfull.subset(sub), tfull.subset(sub)
    assert len(tsub) == len(jsub)
    for pos in (rng.permutation(len(jsub))[:6], np.arange(3), [0]):
        got, want = tsub.get_batch(pos), jsub.get_batch(pos)
        _same_batch(got, want)
        assert got["image_u8"].dtype == np.uint8
        assert got["aug"].dtype == np.int32
    assert tfull.meta == jfull.meta


@pytest.mark.parametrize("multitasking", [True, False])
def test_legacy_patch_dataset_matches_jax(tmp_path, multitasking):
    rng = np.random.default_rng(4)
    heads = {"seg": 5, "bound": 5, "dist": 5, "color": 3}
    (tmp_path / "train").mkdir()
    for h in heads:
        (tmp_path / "labels" / h).mkdir(parents=True)
    for i in range(6):
        np.save(tmp_path / "train" / f"patch_{i}.npy",
                rng.standard_normal((8, 8, 3)).astype(np.float32))
        for h, c in heads.items():
            np.save(tmp_path / "labels" / h / f"patch_{i}.npy",
                    rng.random((8, 8, c)).astype(np.float32))
    jfull = jds.LegacyPatchDataset(str(tmp_path), multitasking=multitasking)
    tfull = tds.LegacyPatchDataset(str(tmp_path), multitasking=multitasking)
    assert len(tfull) == len(jfull) == 6
    for sub, pos in ((np.arange(6), [5, 0, 3]), ([4, 1, 2], [2, 0])):
        _same_batch(tfull.subset(sub).get_batch(pos),
                    jfull.subset(sub).get_batch(pos))


@pytest.mark.parametrize("case", ["resize", "mean"])
def test_directory_pair_dataset_matches_jax(tmp_path, case):
    """The resize case: bilinear images, nearest labels to 16 x 16 (inputs
    of 12 x 20, 9 x 13 and 16 x 16); the mean case: same-size inputs with a
    per-channel mean subtracted. Labels decode from PNG (PIL) and images
    from .npy."""
    rng = np.random.default_rng(6)
    img_dir, lbl_dir = tmp_path / "img", tmp_path / "lbl"
    img_dir.mkdir()
    lbl_dir.mkdir()
    sizes = [(12, 20), (16, 16), (9, 13)] if case == "resize" else \
        [(16, 16)] * 3
    for i, (h, w) in enumerate(sizes):
        np.save(img_dir / f"s{i}.npy",
                rng.standard_normal((h, w, 3)).astype(np.float32) * 50)
        ids = rng.integers(0, 4, (h, w)).astype(np.uint8)
        np.save(lbl_dir / f"s{i}.npy", ids)
    # a PNG pair too: an RGB label image (channel 0 is taken)
    h, w = sizes[0]
    Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
        img_dir / "s9.png")
    Image.fromarray(np.stack([rng.integers(0, 4, (h, w)).astype(np.uint8)] * 3,
                             -1)).save(lbl_dir / "s9.png")
    kw = ({"target_size": (16, 16)} if case == "resize"
          else {"mean": [10.0, -3.5, 7.25]})
    jfull = jds.DirectoryPairDataset(str(img_dir), str(lbl_dir), 4, **kw)
    tfull = tds.DirectoryPairDataset(str(img_dir), str(lbl_dir), 4, **kw)
    assert len(tfull) == len(jfull) == 4
    for sub, pos in ((np.arange(4), [3, 0, 2, 1]), ([2, 3], [1, 0])):
        _same_batch(tfull.subset(sub).get_batch(pos),
                    jfull.subset(sub).get_batch(pos))


def test_array_dataset_matches_jax():
    rng = np.random.default_rng(7)
    arrays = {"image": rng.standard_normal((9, 4, 4, 14)).astype(np.float32),
              "seg": rng.random((9, 4, 4, 2)).astype(np.float32)}
    jfull, tfull = jds.ArrayDataset(arrays), tds.ArrayDataset(arrays)
    assert len(tfull) == len(jfull) == 9
    sub = [8, 1, 4, 6]
    _same_batch(tfull.subset(sub).get_batch([3, 0]),
                jfull.subset(sub).get_batch([3, 0]))


# ----------------------------------------------------------- native loader

@pytest.fixture
def native():
    if tnl.get_lib() is None:
        pytest.skip("no g++: the native loader is not built here")
    return tnl


@pytest.fixture
def numpy_only(monkeypatch):
    """The loader as it runs without a compiler: the build fails, every
    consumer takes the numpy path."""
    def no_compiler(out):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_build_failed", False)
    monkeypatch.setattr(tnl, "library_path",
                        lambda: tnl.BUILD_DIR / "absent.so")
    monkeypatch.setattr(tnl, "_build_so", no_compiler)
    assert tnl.backend() == "numpy"
    return tnl


@pytest.mark.parametrize("kind", ["ndarray", "memmap"])
def test_gather_rows_native_and_numpy_give_the_same_bytes(
        tmp_path, native, kind, monkeypatch):
    rng = np.random.default_rng(8)
    src = rng.integers(0, 256, (40, 6, 5, 3), dtype=np.uint8)
    if kind == "memmap":
        np.save(tmp_path / "m.npy", src)
        src = np.load(tmp_path / "m.npy", mmap_mode="r")
    idx = np.concatenate([rng.integers(0, 40, 25), [-1, -40, 0, 39]])
    want = np.ascontiguousarray(np.asarray(src)[idx])
    assert native.backend() == "native"
    got = native.gather_rows(src, idx)
    assert got.dtype == want.dtype and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        jnl.gather_rows(src, idx[:25]), got[:25])    # the JAX package's
    np.testing.assert_array_equal(native.gather_rows(src, []),
                                  want[:0])
    with pytest.raises(IndexError):
        native.gather_rows(src, [40])
    with pytest.raises(IndexError):
        native.gather_rows(src, [-41])
    # the numpy path without a compiler
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_build_failed", True)
    assert tnl.backend() == "numpy"
    np.testing.assert_array_equal(tnl.gather_rows(src, idx), want)


def test_load_npy_batch_native_and_numpy_give_the_same_bytes(tmp_path,
                                                             native):
    rng = np.random.default_rng(9)
    arrays = [rng.standard_normal((5, 4, 3)).astype(np.float32)
              for _ in range(7)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"patch_{i}.npy"))
        np.save(paths[-1], a)
    got = native.load_npy_batch(paths, (5, 4, 3), np.float32)
    np.testing.assert_array_equal(got, np.stack(arrays))
    np.testing.assert_array_equal(
        jnl.load_npy_batch(paths, (5, 4, 3), np.float32), got)
    # a file of another size: None, the caller takes np.load
    np.save(tmp_path / "bad.npy", np.zeros((2, 2), np.float32))
    assert native.load_npy_batch([str(tmp_path / "bad.npy")], (5, 4, 3),
                                 np.float32) is None


def test_datasets_give_the_same_bytes_without_the_native_loader(
        tmp_path, numpy_only):
    images, ids = synth_patches(4, 16, 3, 5, seed=10)
    root = str(tmp_path / "packed")
    tds.write_packed_dataset(root, images, ids, 5)
    pos = [19, 0, 7, 12]
    _same_batch(tds.PackedDataset(root).get_batch(pos),
                jds.PackedDataset(root).get_batch(pos))
    (tmp_path / "legacy" / "train").mkdir(parents=True)
    (tmp_path / "legacy" / "labels" / "seg").mkdir(parents=True)
    for i in range(3):
        for sub in ("train", "labels/seg"):
            np.save(tmp_path / "legacy" / sub / f"patch_{i}.npy",
                    np.full((4, 4, 3), i, np.float32))
    legacy = str(tmp_path / "legacy")
    assert numpy_only.load_npy_batch([], (4, 4, 3), np.float32) is None
    _same_batch(tds.LegacyPatchDataset(legacy, False).get_batch([2, 0]),
                jds.LegacyPatchDataset(legacy, False).get_batch([2, 0]))


def test_native_library_builds_under_build_loader(native):
    """The port builds its own copy of the loader source into
    build/loader/, the file name carrying a hash of the source and the
    flags; nothing is written beside the source or under native/."""
    path = native.library_path()
    assert path.parent == ROOT / "build" / "loader"
    assert path.exists() and path.name.startswith("libresuneta_loader-")
    assert native.SOURCE == ROOT / "resuneta_torch" / "data" / "csrc" / \
        "loader.cpp"
    assert not list(native.SOURCE.parent.glob("*.so"))


# ------------------------------------------------------------------ split

@pytest.mark.parametrize("n", [2, 5, 9, 40, 50, 1001])
def test_split_matches_sklearn(n):
    sk = pytest.importorskip("sklearn.model_selection")
    idx = np.arange(100, 100 + n)
    want = sk.train_test_split(idx, test_size=0.2, random_state=42)
    got = train_test_split(idx, test_size=0.2, random_state=42)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split_raises_where_sklearn_does():
    sk = pytest.importorskip("sklearn.model_selection")
    with pytest.raises(ValueError):
        sk.train_test_split(np.arange(1), test_size=0.2, random_state=42)
    with pytest.raises(ValueError):
        train_test_split(np.arange(1), test_size=0.2, random_state=42)


# ------------------------------------------------------------------- UNet

def test_unet_carries_the_jax_weights_through_from_flax():
    """convert.from_flax maps the JAX UNet's Conv_0 .. Conv_9 onto the
    port's unchanged (strict keys and shapes); the forward at 32 px, f32,
    within 1e-5 of the Flax module's softmax."""
    jmod = JUNet(num_classes=5, base_filters=8)
    variables = flax_variables(jmod, [jnp.zeros((1, 32, 32, 3))], seed=1)
    model = UNet(5, base_filters=8, device="cpu")
    sd = convert.from_flax(variables, model)
    model.load_state_dict(sd, strict=True)
    assert sorted(sd) == sorted(f"Conv_{i}.{p}" for i in range(10)
                                for p in ("bias", "weight"))
    x = np.random.default_rng(11).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_unet_init_is_seeded_and_raises_without_a_card():
    a = UNet(3, base_filters=4, device="cpu",
             generator=torch.Generator().manual_seed(5))
    b = UNet(3, base_filters=4, device="cpu",
             generator=torch.Generator().manual_seed(5))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            UNet(3, base_filters=4)


# ------------------------------------------------------------ checkpoints

class _Tiny(torch.nn.Module):
    """A conv and a BatchNorm: parameters and running buffers."""

    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.Conv_0 = Conv(3, 4, 3, generator=g)
        self.BatchNorm_0 = BatchNorm(4)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)))


def _trained_state(seed=0, steps=3, lr=1e-3):
    state = create_train_state(_Tiny(seed), "adam", lr)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 6, 6, 3)).astype(np.float32))
    state.model.train()
    for _ in range(steps):
        state.optimizer.zero_grad()
        state.model(x).square().mean().backward()
        state.optimizer.step()
        state.step += 1
    return state


def _assert_same_state(got, want):
    for (k, v), w in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(v, w), k
    gopt, wopt = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert gopt["param_groups"] == wopt["param_groups"]
    assert sorted(gopt["state"]) == sorted(wopt["state"])
    for i, st in wopt["state"].items():
        for k, v in st.items():
            assert torch.equal(gopt["state"][i][k], v), (i, k)
    assert got.step == want.step


def test_save_best_restore_round_trips_bit_for_bit(tmp_path):
    """Parameters, BN running buffers, Adam's moments and step counts, the
    learning rate and the train step; the meta JSON beside it."""
    state = _trained_state()
    moved = state.model.BatchNorm_0.mean
    assert moved.abs().sum() > 0
    ckpt = str(tmp_path / "best_model.ckpt")
    checkpoint.save_best(ckpt, state, epoch=3, min_loss=0.5)
    assert (tmp_path / "best_model.ckpt" / checkpoint.CKPT_FILE).exists()
    fresh = create_train_state(_Tiny(1), "adam", 1e-3)
    restored, meta = checkpoint.restore(ckpt, fresh)
    assert restored is fresh
    assert meta == {"epoch": 3, "min_val_loss": 0.5}
    _assert_same_state(restored, state)
    # the file itself restores too; a path with no meta gives {}
    again, meta = checkpoint.restore(
        os.path.join(ckpt, checkpoint.CKPT_FILE),
        create_train_state(_Tiny(2), "adam", 1e-3))
    assert meta == {}
    _assert_same_state(again, state)


def test_restore_applies_the_learning_rate_override(tmp_path):
    state = _trained_state(lr=1e-3)
    ckpt = str(tmp_path / "c.ckpt")
    checkpoint.save_best(ckpt, state, 0, 1.0)
    fresh = create_train_state(_Tiny(1), "adam", 1e-3)
    restored, _ = checkpoint.restore(ckpt, fresh, learning_rate_override=5e-4)
    assert restored.learning_rate == 5e-4
    assert all(g["lr"] == 5e-4 for g in restored.optimizer.param_groups)
    assert restored.step == state.step


def test_restore_names_the_converter_for_an_orbax_checkpoint(tmp_path):
    orbax_dir = tmp_path / "best_model.ckpt"
    orbax_dir.mkdir()
    (orbax_dir / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="flax_ckpt_to_npz.py"):
        checkpoint.restore(str(orbax_dir), _trained_state(steps=0))
    with pytest.raises(ValueError, match="restore_variables"):
        checkpoint.restore(str(orbax_dir), _trained_state(steps=0))


def test_async_saver_keeps_the_last_epochs(tmp_path):
    state = _trained_state()
    root = tmp_path / "checkpoints"
    with checkpoint.AsyncSaver(keep_last=2) as saver:
        saver.save_best(str(tmp_path / "best.ckpt"), state, epoch=0,
                        min_loss=1.0)
        for e in range(5):
            saver.save_epoch(str(root), state, epoch=e)
        saver.wait()
        assert sorted(os.listdir(root)) == ["epoch_3", "epoch_4"]
    restored, meta = checkpoint.restore(
        str(root / "epoch_4"), create_train_state(_Tiny(1), "adam", 1e-3))
    _assert_same_state(restored, state)
    assert meta == {}
    _, meta = checkpoint.restore(str(tmp_path / "best.ckpt"),
                                 create_train_state(_Tiny(1), "adam", 1e-3))
    assert meta == {"epoch": 0, "min_val_loss": 1.0}


def test_async_saver_copies_first_and_writes_the_meta_last(tmp_path,
                                                           monkeypatch):
    """save_best returns with the payload already copied to the CPU (a
    later step does not change what is saved); while the write is held,
    neither the checkpoint nor its meta JSON is on disk; after it, both."""
    release, entered = threading.Event(), threading.Event()
    save = torch.save

    def held_save(obj, path):
        entered.set()
        assert release.wait(10)
        save(obj, path)

    monkeypatch.setattr(checkpoint.torch, "save", held_save)
    state = _trained_state()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt = tmp_path / "best.ckpt"
    saver = checkpoint.AsyncSaver()
    try:
        saver.save_best(str(ckpt), state, epoch=2, min_loss=0.25)
        assert entered.wait(10)
        with torch.no_grad():                 # the next step
            for p in state.model.parameters():
                p.add_(1.0)
        assert not (ckpt / checkpoint.CKPT_FILE).exists()
        assert not Path(str(ckpt) + ".meta.json").exists()
        release.set()
        saver.wait()
        assert (ckpt / checkpoint.CKPT_FILE).exists()
        assert json.loads(Path(str(ckpt) + ".meta.json").read_text()) == \
            {"epoch": 2, "min_val_loss": 0.25}
    finally:
        release.set()
        saver.close()
    saved = torch.load(ckpt / checkpoint.CKPT_FILE, weights_only=True)
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
    assert not [p for p in os.listdir(ckpt) if p.endswith(".tmp")]


def test_async_saver_raises_a_failed_write(tmp_path, monkeypatch):
    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken)
    saver = checkpoint.AsyncSaver()
    saver.save_best(str(tmp_path / "b.ckpt"), _trained_state(steps=0), 0, 1.0)
    with pytest.raises(OSError, match="disk full"):
        saver.close()
    assert not Path(str(tmp_path / "b.ckpt") + ".meta.json").exists()
