"""The port's Keras-shaped entry points (resuneta_torch/compat.py) and the
legacy drivers (cli/legacy_train.py, cli/legacy_test.py) on the CPU; the
counterpart of tests/test_legacy_driver.py:40-80.

The legacy driver trains at 64 px, 3 classes, 2 epochs, batch 2 on a
directory of PNG image/label pairs, reloads its best checkpoint in a fresh
driver, predicts and renders. The images are low-contrast (pixels within
~25 of the config mean): at random init a full-range image saturates the
legacy model's softmax and the dual Tanimoto's prediction-volume weights
turn inf, in JAX as in the port (tests/test_torch_variants.py). Resunet_a
predicts with the port's own weights and with JAX's, converted, against
JAX's Resunet_a.predict within the forward tolerance of
tests/test_torch_model.py (5e-3: K1's plain version rounds z and the taps
to bf16 where JAX's CPU path runs f32)."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from resuneta_torch.cli import legacy_test, legacy_train
from resuneta_torch.compat import Resunet_a, UNet
from resuneta_torch.data.dataset import _resize_bilinear
from resuneta_torch.train import checkpoint
from resuneta_torch.utils.config import UnetConfig
from resuneta_tpu.compat import Resunet_a as JResunet_a
from test_torch_model import flax_variables
from util_torch import one_thread  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("postdam")
    rng = np.random.default_rng(0)
    mean = np.asarray(UnetConfig().MEAN)
    for sub in ("train", "label", "test"):
        os.makedirs(root / sub)
    for i in range(6):
        img = (mean + rng.normal(0, 8, (64, 64, 3))).clip(0, 255)
        Image.fromarray(img.astype(np.uint8)).save(root / "train" / f"p{i}.png")
        # a 3-channel label image: the loader takes channel 0
        lab = rng.integers(0, 3, (64, 64), dtype=np.uint8)
        Image.fromarray(np.stack([lab] * 3, -1)).save(
            root / "label" / f"p{i}.png")
    img = (mean + rng.normal(0, 8, (96, 80, 3))).clip(0, 255)
    Image.fromarray(img.astype(np.uint8)).save(root / "test" / "t0.png")
    return root


def _config():
    c = UnetConfig()
    c.IMAGE_H = c.IMAGE_W = 64
    c.CLASSES_NUM = 3
    c.EPOCHS = 2
    c.BATCH_SIZE = 2
    return c


@pytest.mark.usefixtures("one_thread")
def test_train_load_predict_visual(dataset, tmp_path):
    logdir = str(tmp_path / "logs")
    unet = UNet(config=_config(), device="cpu")
    history = unet.train(str(dataset), logdir)
    assert len(history) == 2
    assert all(np.isfinite(v) for h in history for split in ("train", "val")
               for v in h[split].values())
    ckpt = os.path.join(logdir, "best_model.ckpt")
    assert os.path.isfile(os.path.join(ckpt, checkpoint.CKPT_FILE))

    # a fresh driver restores the best checkpoint bit for bit
    unet2 = UNet(config=_config(), device="cpu")
    unet2.loadWeight(logdir)
    saved = torch.load(os.path.join(ckpt, checkpoint.CKPT_FILE),
                       map_location="cpu", weights_only=True)
    for k, v in unet2.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k

    img = np.asarray(Image.open(dataset / "test" / "t0.png"))
    img = _resize_bilinear(img, 64, 64)
    result = unet2.predict(img)
    assert result.shape == (64, 64)
    assert result.min() >= 0 and result.max() < 3
    # predict is the model's mean-subtract -> eval forward -> argmax
    with torch.no_grad():
        probs = unet2.model.eval()(torch.from_numpy(
            (img - np.asarray(_config().MEAN, np.float32))[None]))
    np.testing.assert_array_equal(result, probs[0].argmax(-1).numpy())

    out = tmp_path / "test-result" / "0.png"
    unet2.visual(result, str(out))
    rendered = np.asarray(Image.open(out))
    assert rendered.shape == (64, 64, 3)


@pytest.mark.parametrize("variant", ["model2", "v1"])
@pytest.mark.usefixtures("one_thread")
def test_resunet_a_predict(variant):
    """init draws seeded weights (another seed, other weights); predict
    in batches over a padded tail; with JAX's variables it predicts what
    JAX's Resunet_a.predict does within 5e-3 on every head."""
    args = SimpleNamespace(multitasking=True)
    x = np.random.default_rng(7).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    net = Resunet_a((64, 64, 3), 5, args, variant=variant, device="cpu")
    sd0 = {k: v.clone() for k, v in net.init(seed=0).items()}
    sd1 = net.init(seed=1)
    assert any(not torch.equal(sd0[k], sd1[k]) for k in sd0)
    own = net.predict(x, batch_size=2)
    assert sorted(own) == ["bound", "color", "dist", "seg"]
    assert own["seg"].shape == (3, 64, 64, 5)

    jnet = JResunet_a((64, 64, 3), 5, args, variant=variant)
    variables = flax_variables(jnet.model, [jnp.asarray(x[:1])], seed=31)
    want = jnet.predict(x, variables=variables, batch_size=2)
    got = net.predict(x, variables=variables, batch_size=2)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=5e-3, err_msg=k)


@pytest.mark.usefixtures("one_thread")
def test_legacy_clis_with_environment_overrides(dataset, tmp_path,
                                                monkeypatch, capsys):
    """legacy_train then legacy_test on the CPU through their main, the
    dataset, log and output directories from RESUNETA_DATASET,
    RESUNETA_LOGS and RESUNETA_OUT, the config from the flags."""
    monkeypatch.setenv("RESUNETA_DATASET", str(dataset))
    monkeypatch.setenv("RESUNETA_LOGS", str(tmp_path / "logs"))
    monkeypatch.setenv("RESUNETA_OUT", str(tmp_path / "out"))
    flags = ["--image_size", "64", "--num_classes", "3", "--device", "cpu"]
    history = legacy_train.main(flags + ["--epochs", "1", "--batch_size",
                                         "2"])
    text = capsys.readouterr().out
    assert "Configuration:" in text and "IMAGE_W" in text
    assert len(history) == 1 and np.isfinite(history[0]["train"]["loss"])
    assert (tmp_path / "logs" / "best_model.ckpt" /
            checkpoint.CKPT_FILE).exists()
    results = legacy_test.main(flags)
    assert len(results) == 1 and results[0].shape == (64, 64)
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png"]
