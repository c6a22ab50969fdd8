"""The port's Amazon CLIs and ISPRS preprocess CLI on the CPU
(--device cpu), on small synthetic scenes:

- preprocess_amazon against the JAX CLI on tests/test_e2e_amazon.py's
  synthetic tree: the manifest (class weights included) and the labels
  bit for bit, the images within the whole-image normalization's
  tolerance (an f32 mean and std summed in another order: 1e-6, as
  tests/test_torch_infer.py holds normalization);
- train_amazon with the UNet at 32 px in its three dataset modes (the tile
  split with the whole-scene eval, --preprocessed_path, --use_tiles
  False), then test_amazon on the tile run's checkpoint, whose confusion
  matrix and metrics equal those the training's eval printed;
- preprocess_isprs: the packed layout bit for bit against the JAX CLI;
  the legacy tree against the port's own augment, normalize and label ops
  (held to the JAX package in tests/test_torch_labels.py and
  tests/test_torch_train.py), bit for bit;
- the CLIs ask for the card when no device is named."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from util_synth import synth_scene
from util_torch import one_thread  # noqa: F401  (a fixture)
from resuneta_torch.data import isprs as tisprs

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def amazon_root(tmp_path_factory):
    """tests/test_e2e_amazon.py's synthetic Amazon_npy tree: two 2-band CHW
    years of 160 x 96 (32 x 32 tiles), blobs of deforestation, a past
    reference and an all -1 valid mask."""
    root = tmp_path_factory.mktemp("amazon_npy")
    rng = np.random.default_rng(0)
    H, W, B = 160, 96, 2
    for name in ("t1", "t2"):
        np.save(root / f"{name}.npy",
                rng.standard_normal((B, H, W)).astype(np.float32))
    ref = np.zeros((H, W), np.uint8)
    for r0, c0 in ((5, 5), (40, 40), (70, 10), (100, 60), (130, 30)):
        ref[r0:r0 + 12, c0:c0 + 12] = 1
    (root / "labels").mkdir()
    np.save(root / "labels" / "ref2019.npy", ref)
    past = np.zeros((H, W), np.uint8)
    past[0:4, 0:4] = 1
    np.save(root / "labels" / "past.npy", past)
    np.save(root / "mask_ref.npy", np.full((H, W), -1.0, np.float32))
    return root


def _scene_args(root):
    return ["--dataset_path", str(root), "--image_t1", "t1.npy",
            "--image_t2", "t2.npy", "--reference", "labels/ref2019.npy",
            "--past_reference", "labels/past.npy", "--num_classes", "3"]


PREP = ["--patch_size", "32", "--stride", "16", "--def_percent", "2",
        "--mask_ref", "mask_ref.npy", "--train_tiles", "1", "4", "7",
        "--val_tiles", "11"]
TRAIN = ["-ps", "32", "-bs", "4", "--epochs", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def prepared(amazon_root, tmp_path_factory):
    from resuneta_torch.cli.preprocess_amazon import main

    out = tmp_path_factory.mktemp("amazon_ds")
    main(_scene_args(amazon_root) + PREP + ["--output_path", str(out),
                                            "--device", "cpu"])
    return out


def test_preprocess_amazon_matches_jax(amazon_root, prepared, tmp_path):
    from resuneta_tpu.cli.preprocess_amazon import main as jmain

    jmain(_scene_args(amazon_root) + PREP + ["--output_path", str(tmp_path)])
    got = json.loads((prepared / "manifest.json").read_text())
    assert got == json.loads((tmp_path / "manifest.json").read_text())
    assert got["format"] == "amazon-packed-v1" and got["channels"] == 4
    assert got["splits"]["train"]["num_patches"] > 0
    for split in ("train", "val"):
        a = np.load(prepared / f"{split}_labels.npy")
        b = np.load(tmp_path / f"{split}_labels.npy")
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        a = np.load(prepared / f"{split}_images.npy")
        b = np.load(tmp_path / f"{split}_images.npy")
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def _block(text):
    """The eval's printout from the confusion matrix to the precision."""
    i = text.index("Confusion  matrix")
    return text[i:text.index("\n", text.index("Precision:", i))]


def test_train_amazon_three_modes_and_test_cli(amazon_root, prepared,
                                               tmp_path, capsys):
    from resuneta_torch.cli.test_amazon import main as test_main
    from resuneta_torch.cli.train_amazon import main

    tiles = ["--stride", "16", "--percent", "2", "--area", "4",
             "--train_tiles", "1", "4", "7", "--val_tiles", "11",
             "--test_tiles", "2", "5"]
    run = tmp_path / "tiles"
    state, history = main(_scene_args(amazon_root) + TRAIN + tiles +
                          ["-rp", str(run)])
    train_out = capsys.readouterr().out
    assert len(history) == 1 and state.step > 0
    assert np.isfinite(list(history[0]["val"].values())).all()
    assert (run / "best_model.ckpt" / "checkpoint.pt").exists()
    prob = np.load(run / "prob_reconstructed.npy")
    assert prob.shape == (160, 96) and prob.dtype == np.float32
    assert "Area to be analyzed" in train_out

    for extra, name in ((["--preprocessed_path", str(prepared)], "prep"),
                        (["--use_tiles", "False", "--mask_ref",
                          "mask_ref.npy", "--stride", "32", "--percent",
                          "2"], "no_tiles")):
        st, hist = main(_scene_args(amazon_root) + TRAIN + extra +
                        ["-rp", str(tmp_path / name)])
        out = capsys.readouterr().out
        assert len(hist) == 1 and st.step > 0, name
        assert np.isfinite(list(hist[0]["train"].values())).all(), name
        assert (tmp_path / name / "best_model.ckpt" / "checkpoint.pt") \
            .exists()
        # the preprocessed mode skips the whole-scene eval, as the JAX CLI
        assert ("Confusion  matrix" in out) == (name == "no_tiles"), name

    preds = tmp_path / "preds"
    metrics, cm = test_main(
        _scene_args(amazon_root) + ["-ps", "32", "--device", "cpu",
                                    "--area", "4", "--test_tiles", "2", "5",
                                    "--model_path",
                                    str(run / "best_model.ckpt"),
                                    "--output_path", str(preds),
                                    "--thresholds", "0.3", "0.5", "0.7"])
    test_out = capsys.readouterr().out
    # one epoch: the best checkpoint holds the weights the eval ran
    assert _block(test_out) == _block(train_out)
    for word in ("Alarm area:", "Recall curve:", "Precision curve:",
                 "Alarm-area curve:", "test time"):
        assert word in test_out, word
    np.testing.assert_array_equal(np.load(preds / "prob_reconstructed.npy"),
                                  prob)
    assert cm.sum() > 0 and 0.0 <= metrics[0] <= 100.0
    assert (preds / "color_map.png").exists()
    assert (preds / "threshold_sweep.png").exists()


def _isprs_root(root, h=96, w=128):
    image, ids = synth_scene(h, w, seed=9)
    np.save(root / "Image_Train.npy", image.transpose(2, 0, 1))
    np.save(root / "Reference_Train.npy",
            tisprs.class_ids_to_rgb(ids).transpose(2, 0, 1))
    return image, ids


def test_preprocess_isprs_packed_matches_jax(tmp_path):
    from resuneta_torch.cli.preprocess_isprs import main
    from resuneta_tpu.cli.preprocess_isprs import main as jmain

    _isprs_root(tmp_path)
    args = ["--dataset_path", str(tmp_path), "--patch_size", "32",
            "--stride", "16", "--norm_type", "2"]
    main(args + ["--output_path", str(tmp_path / "port"), "--device", "cpu"])
    jmain(args + ["--output_path", str(tmp_path / "jax")])
    for name in ("images.npy", "labels.npy", "manifest.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("data_aug,norm_type", [(True, 1), (False, 3)])
def test_preprocess_isprs_legacy_tree(tmp_path, data_aug, norm_type):
    """Every file of the tree against the port's ops on its patch: the
    augment variant, normalize_rgb (per-patch standardisation for
    norm_type 3), the one-hot, the boundary (K6's plain version), the
    distance (K5's) and the HSV colour labels, bit for bit."""
    from resuneta_torch.cli.preprocess_isprs import main
    from resuneta_torch.ops.augment import augment_batch
    from resuneta_torch.ops.boundary import get_boundary_label
    from resuneta_torch.ops.colorspace import (hsv_color_label,
                                               standardize_per_sample)
    from resuneta_torch.ops.distance import get_distance_label
    from resuneta_torch.ops.normalize import normalize_rgb
    from resuneta_torch.ops.patches import extract_patches

    image, ids = _isprs_root(tmp_path, 64, 96)
    out = tmp_path / "tree"
    main(["--dataset_path", str(tmp_path), "--patch_size", "32", "--stride",
          "32", "--layout", "legacy", "--data_aug", str(data_aug),
          "--norm_type", str(norm_type), "--output_path", str(out),
          "--device", "cpu"])
    patches, refs = extract_patches(image, ids, 32, 32)
    n_var = 5 if data_aug else 1
    assert len(os.listdir(out / "train")) == len(patches) * n_var == \
        6 * n_var
    for i in range(len(patches)):
        for j in range(n_var):
            img = augment_batch(torch.from_numpy(patches[i:i + 1]), [j])
            lab = augment_batch(torch.from_numpy(refs[i:i + 1]), [j])
            onehot = F.one_hot(lab.long(), 5).float()
            norm = normalize_rgb(img, 1) if norm_type == 1 else \
                standardize_per_sample(img)
            want = {"train": norm, "labels/seg": onehot,
                    "labels/bound": get_boundary_label(onehot),
                    "labels/dist": get_distance_label(onehot),
                    "labels/color": hsv_color_label(img, norm_type)}
            name = f"patch_{i * 5 + j}.npy" if data_aug else f"patch_{i}.npy"
            for sub, w in want.items():
                got = np.load(out / sub / name)
                assert got.dtype == np.float32, (sub, name)
                np.testing.assert_array_equal(got, w[0].numpy(),
                                              err_msg=f"{sub} {name}")


def test_clis_ask_for_the_card(monkeypatch, amazon_root, prepared, tmp_path):
    from resuneta_torch.cli import (preprocess_amazon, preprocess_isprs,
                                    test_amazon, train_amazon)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _isprs_root(tmp_path, 32, 32)
    calls = (
        (preprocess_amazon.main, _scene_args(amazon_root) + PREP +
         ["--output_path", str(tmp_path / "a")]),
        (train_amazon.main, _scene_args(amazon_root) +
         ["-ps", "32", "--preprocessed_path", str(prepared)]),
        (test_amazon.main, _scene_args(amazon_root) +
         ["-ps", "32", "--model_path", str(tmp_path / "none")]),
        (preprocess_isprs.main, ["--dataset_path", str(tmp_path),
                                 "--patch_size", "32", "--output_path",
                                 str(tmp_path / "b")]))
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
