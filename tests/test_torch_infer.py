"""The PyTorch port's inference path around the model: normalization, patch
chop and reconstruction, metrics and label colours against the JAX package
(exact where the arithmetic is the same), the sliding-window functions, the
ISPRS CLI, and the rule that an entry point called without a device asks
for the card."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synth import synth_scene
from util_torch import one_thread  # noqa: F401  (a fixture)
from resuneta_torch import metrics as tmetrics
from resuneta_torch.data import isprs as tisprs
from resuneta_torch.infer import sliding as tsliding
from resuneta_torch.models import ResUnetA
from resuneta_torch.ops import convseg
from resuneta_torch.ops import normalize as tnorm
from resuneta_torch.ops import patches as tpatches
from resuneta_tpu import metrics as jmetrics
from resuneta_tpu.data import isprs as jisprs
from resuneta_tpu.infer import sliding as jsliding
from resuneta_tpu.ops import normalize as jnorm
from resuneta_tpu.ops import patches as jpatches


# ---------------------------------------------------------- normalization

@pytest.mark.parametrize("norm_type", [1, 2, 3])
def test_normalize_rgb_matches_jax(norm_type):
    img = np.random.default_rng(norm_type).integers(
        0, 256, (4, 16, 16, 3)).astype(np.uint8)
    want = np.asarray(jnorm.normalize_rgb(jnp.asarray(img), norm_type))
    got = tnorm.normalize_rgb(torch.from_numpy(img), norm_type).numpy()
    assert got.dtype == np.float32
    if norm_type == 3:
        # the mean and std are f32 reductions, summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm_type", [1, 2, 3])
def test_whole_image_normalization_matches_jax(norm_type):
    img = np.random.default_rng(10 + norm_type).uniform(
        0, 255, (3, 40, 24)).astype(np.float32)
    img[1] = 7.0    # a constant channel: zero std / range divides by 1
    want = np.asarray(jnorm.normalization(jnp.asarray(img), norm_type))
    got = tnorm.normalization(torch.from_numpy(img), norm_type).numpy()
    if norm_type == 1:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_norm_type_2_keeps_the_reference_quirk():
    x = torch.tensor([253.0])
    assert tnorm.normalize_rgb(x, 2).item() == pytest.approx(2.0)


# ----------------------------------------------------------------- patches

@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("channels", [0, 3])
def test_patches_match_jax(order, channels):
    shape = (70, 100) + ((channels,) if channels else ())
    img = np.random.default_rng(channels).integers(0, 9, shape).astype(
        np.int32)
    want = jpatches.extract_patches_nonoverlap(img, 16, order=order)
    got = tpatches.extract_patches_nonoverlap(img, 16, order=order)
    np.testing.assert_array_equal(got, want)
    got_t = tpatches.extract_patches_nonoverlap(torch.from_numpy(img), 16,
                                                order=order)
    np.testing.assert_array_equal(got_t.numpy(), want)
    back = tpatches.reconstruct_from_patches(got, 70, 100, order=order)
    np.testing.assert_array_equal(
        back, jpatches.reconstruct_from_patches(want, 70, 100, order=order))
    np.testing.assert_array_equal(back, img[:64, :96])


# ----------------------------------------------------------------- metrics

def test_metrics_and_labels_match_jax():
    rng = np.random.default_rng(4)
    t = rng.integers(0, 5, 5000)
    p = np.where(rng.uniform(size=5000) < 0.7, t, rng.integers(0, 4, 5000))
    cm = tmetrics.confusion_matrix(t, p)
    np.testing.assert_array_equal(cm, jmetrics.confusion_matrix(t, p))
    for a, b in zip(tmetrics.compute_metrics(t, p),
                    jmetrics.compute_metrics(t, p)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmetrics.iou_per_class(cm),
                                  jmetrics.iou_per_class(cm))
    m_t, ious_t = tmetrics.mean_iou(t, p, labels=range(6))
    m_j, ious_j = jmetrics.mean_iou(t, p, labels=range(6))
    assert m_t == m_j
    np.testing.assert_array_equal(ious_t, ious_j)

    ids = synth_scene(40, 56, seed=2)[1]
    np.testing.assert_array_equal(tisprs.class_ids_to_rgb(ids),
                                  jisprs.class_ids_to_rgb(ids))
    rgb = jisprs.class_ids_to_rgb(ids)
    rgb[0, 0] = (1, 2, 3)     # an unknown colour maps to 255
    np.testing.assert_array_equal(tisprs.binarize_matrix(rgb),
                                  jisprs.binarize_matrix(rgb))
    str_keys = {str(k): v for k, v in tisprs.LABEL_DICT.items()}
    np.testing.assert_array_equal(tisprs.binarize_matrix(rgb, str_keys),
                                  jisprs.binarize_matrix(rgb, str_keys))


# --------------------------------------------------- sliding-window functions

_M = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)


def _toy_torch(x):
    """A per-pixel 'model': softmax of a fixed linear map of the pixel."""
    return {"seg": torch.softmax(torch.as_tensor(x).float() @
                                 torch.from_numpy(_M), dim=-1)}


def _toy_jax(x):
    return {"seg": jnp.asarray(np.asarray(
        _toy_torch(np.array(x))["seg"]))}


def test_sliding_functions_match_jax():
    img = np.random.default_rng(3).uniform(size=(48, 80, 3)).astype(
        np.float32)
    cmap_t, preds_t = tsliding.predict_scene(_toy_torch, img, 16,
                                             batch_size=4)
    cmap_j, preds_j = jsliding.predict_scene(_toy_jax, img, 16, batch_size=4)
    np.testing.assert_array_equal(cmap_t, cmap_j)
    np.testing.assert_allclose(preds_t["seg"], preds_j["seg"], rtol=0,
                               atol=0)
    ids_t, pids = tsliding.predict_scene(_toy_torch, img, 16, batch_size=4,
                                         ids_only=True)
    assert pids.dtype == np.uint8 and pids.shape == (15, 16, 16)
    np.testing.assert_array_equal(ids_t, cmap_j)
    for stride in (16, 8, 6):
        ov_t, mean_t = tsliding.predict_scene_overlap(
            _toy_torch, img, 16, stride, batch_size=5)
        ov_j, mean_j = jsliding.predict_scene_overlap(
            _toy_jax, img, 16, stride, batch_size=5)
        np.testing.assert_array_equal(ov_t, ov_j)
        np.testing.assert_allclose(mean_t, mean_j, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def model64():
    return ResUnetA(5, img_size=64, multitasking=True,
                    generator=torch.Generator().manual_seed(0), device="cpu")


def test_predict_scene_ids_regime_on_cpu(model64):
    """The production regime (uint8 in, normalize and argmax on the device,
    uint8 ids out) equals the full-output regime, with 44 K1 segments per
    batch; the 2-patch tail batch is padded to the batch size."""
    image, _ = synth_scene(128, 192, seed=1)      # 6 patches at 64 px
    ids_fn = tsliding.make_seg_ids_fn(model64, norm_type=1, device="cpu")
    calls = convseg.CALLS
    cmap, ids = tsliding.predict_scene(ids_fn, image, 64, batch_size=4,
                                       ids_only=True)
    assert convseg.CALLS - calls == 44 * 2
    assert cmap.shape == (128, 192) and cmap.dtype == np.uint8
    assert ids.shape == (6, 64, 64) and ids.max() < 5

    apply_fn = tsliding.make_apply_fn(model64, device="cpu")
    norm = tnorm.normalize_rgb(torch.from_numpy(image), 1).numpy()
    cmap_full, preds = tsliding.predict_scene(apply_fn, norm, 64,
                                              batch_size=4)
    assert sorted(preds) == ["bound", "color", "dist", "seg"]
    assert preds["seg"].shape == (6, 64, 64, 5)
    np.testing.assert_array_equal(cmap, cmap_full)

    ov, mean = tsliding.predict_scene_overlap(apply_fn, norm, 64, 64,
                                              batch_size=4)
    np.testing.assert_array_equal(ov, cmap_full)
    np.testing.assert_allclose(
        mean, tpatches.reconstruct_from_patches(preds["seg"], 128, 192),
        rtol=0, atol=1e-6)


def _write_scene(root, h=128, w=192):
    image, ids = synth_scene(h, w, seed=5)
    np.save(os.path.join(root, "Image_Test.npy"), image.transpose(2, 0, 1))
    np.save(os.path.join(root, "Reference_Test.npy"),
            tisprs.class_ids_to_rgb(ids).transpose(2, 0, 1))
    return image, ids


@pytest.mark.parametrize("fmt", ["pt", "npz"])
@pytest.mark.usefixtures("one_thread")
def test_cli_on_a_synthetic_scene(tmp_path, capsys, model64, fmt):
    from resuneta_torch.cli.test_isprs import main
    from resuneta_torch.convert import flatten
    from resuneta_torch.train.checkpoint import save_variables

    _write_scene(str(tmp_path))
    if fmt == "pt":
        weights = str(tmp_path / "weights.pt")
        save_variables(weights, model64)
    else:   # flattened Flax variables, as tools/flax_ckpt_to_npz.py writes
        weights = str(tmp_path / "weights.npz")
        inverse = {"weight": "params/{}/kernel", "bias": "params/{}/bias",
                   "scale": "params/{}/scale", "mean": "batch_stats/{}/mean",
                   "var": "batch_stats/{}/var"}
        flat = {}
        for name, t in model64.state_dict().items():
            path, leaf = name.rsplit(".", 1)
            v = t.numpy()
            flat[inverse[leaf].format(path.replace(".", "/"))] = \
                v.transpose(2, 3, 1, 0) if leaf == "weight" else v
        assert sorted(flatten(flat)) == sorted(flat)
        np.savez(weights, **flat)
    out = tmp_path / "preds"
    metrics, cm = main(["--model_path", weights, "--dataset_path",
                        str(tmp_path), "-ps", "64", "--use_multitasking",
                        "--output_path", str(out), "--batch_size", "4",
                        "--max_viz_patches", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    for word in ("Confusion  matrix", "Accuracy", "F1score", "Recall",
                 "Precision", "IoU per class", "mIoU"):
        assert word in text, word
    # the multitask figures of the first --max_viz_patches patches
    assert sorted(p.name for p in out.iterdir()) == [
        "pred0_classes.jpg", "pred0_color.jpg", "pred1_classes.jpg",
        "pred1_color.jpg", "pred_seg_reconstructed.jpeg"]
    assert cm.sum() == 128 * 192
    assert 0.0 <= metrics[0] <= 100.0


@pytest.mark.usefixtures("one_thread")
def test_cli_evaluates_a_unet_checkpoint(tmp_path, capsys):
    """--resunet_a False: the UNet baseline, single-task, from a training
    checkpoint directory as the train CLI writes it (best_model.ckpt)."""
    from resuneta_torch.cli.test_isprs import main
    from resuneta_torch.models import UNet
    from resuneta_torch.train import checkpoint, create_train_state

    _write_scene(str(tmp_path))
    weights = str(tmp_path / "best_model.ckpt")
    checkpoint.save_best(weights, create_train_state(UNet(5, device="cpu")),
                         0, 1.0)
    metrics, cm = main(["--model_path", weights, "--dataset_path",
                        str(tmp_path), "-ps", "64", "--resunet_a", "False",
                        "--output_path", str(tmp_path / "preds"),
                        "--batch_size", "4", "--device", "cpu"])
    assert "mIoU" in capsys.readouterr().out
    assert cm.sum() == 128 * 192
    assert (tmp_path / "preds" / "pred_seg_reconstructed.jpeg").exists()


# ----------------------------------------------------------- default device

def test_entry_points_without_a_device_ask_for_the_card(monkeypatch,
                                                        model64, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResUnetA(5, img_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsliding.make_apply_fn(model64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsliding.make_seg_ids_fn(model64, norm_type=1)
    from resuneta_torch.cli.test_isprs import main
    from resuneta_torch.train.checkpoint import save_variables
    _write_scene(str(tmp_path), 64, 64)
    save_variables(str(tmp_path / "w.pt"), model64)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model_path", str(tmp_path / "w.pt"), "--dataset_path",
              str(tmp_path), "-ps", "64", "--use_multitasking"])
