"""Keras-shaped entry points for users of the reference
(resuneta_tpu/compat.py).

`Resunet_a(input_shape, num_classes, args)` mirrors the reference's
constructor (ResUnet_a/model2.py:6-12): `.model` is the port's module,
`.init(seed)` draws its weights, `.predict(x, batch_size)` runs it like
Keras' model.predict. `UNet(config)` is the legacy config-driven driver
that the reference's ResUnet_a/train.py and test.py call and upstream
never shipped: the size-adaptive legacy model trained with Adam(1e-3) and
Tanimoto over a directory of image/label pairs, `loadWeight`, `predict`
(mean subtraction, argmax) and `visual` (the ISPRS palette).

Each takes `device=None`, the card (it raises without one); pass
device="cpu" for the plain PyTorch path.
"""

import os
from types import SimpleNamespace

import numpy as np
import torch

from .device import resolve_device
from .models import ResUnetA, ResUnetALegacy, ResUnetAV1


class Resunet_a:
    """Resunet_a((H, W, C), num_classes, args, variant="model2" | "v1").
    args needs `.multitasking` (`.gpu_parallel` is ignored: data
    parallelism is the train CLIs' concern, not the model's)."""

    def __init__(self, input_shape, num_classes, args=None, inputs=None,
                 variant="model2", device=None):
        args = args or SimpleNamespace(multitasking=True)
        self.img_height, self.img_width, self.img_channel = input_shape
        self.num_classes = num_classes
        self.args = args
        self.device = resolve_device(device)
        self._cls = ResUnetA if variant == "model2" else ResUnetAV1
        self._kw = dict(num_classes=num_classes, img_size=self.img_width,
                        multitasking=bool(getattr(args, "multitasking",
                                                  True)),
                        in_channels=self.img_channel)
        self.model = self._cls(device=self.device, **self._kw)

    def init(self, seed=0):
        """Fresh weights drawn from `seed`; returns the state_dict."""
        fresh = self._cls(generator=torch.Generator().manual_seed(seed),
                          device="cpu", **self._kw)
        self.model.load_state_dict(fresh.state_dict())
        return self.model.state_dict()

    def predict(self, x, variables=None, batch_size=32):
        """NHWC patches -> the model's outputs (numpy), in batches.
        `variables`: a state_dict of the port or Flax variables
        ({"params": ..., "batch_stats": ...}, nested or flat), loaded
        first."""
        from .convert import from_flax
        from .infer import make_apply_fn, predict_patches

        if variables is not None:
            flax = any(str(k).split("/")[0] in ("params", "batch_stats")
                       for k in variables)
            self.model.load_state_dict(
                from_flax(variables, self.model) if flax else variables)
        return predict_patches(make_apply_fn(self.model, self.device),
                               np.asarray(x, np.float32), batch_size)


class UNet:
    """The legacy driver (resuneta_tpu/compat.py UNet): ResUnetALegacy at
    the config's size with Adam(1e-3, beta1 0.9) and the single-task
    Tanimoto dual loss (model_old.py:169-171; its own Tanimoto_loss lacks
    a return, so the family's working loss is used), trained over a
    DataGenerator-equivalent directory pair: images under
    `{dataset_dir}/train`, same-named label maps under
    `{dataset_dir}/label` (.npy class-id maps or image files; a
    multi-channel label image gives its channel 0, ResUnet_a/utils.py:
    27-35, 53), resized to the config's size and mean-subtracted."""

    def __init__(self, config=None, device=None):
        from .utils.config import UnetConfig

        self.config = config or UnetConfig()
        c = self.config
        self.device = resolve_device(device)
        self.model = ResUnetALegacy(num_classes=c.CLASSES_NUM,
                                    img_size=c.IMAGE_W, mean=tuple(c.MEAN),
                                    in_channels=c.IMAGE_C,
                                    device=self.device)
        self._state = None

    def _make_state(self):
        from .train import create_train_state

        return create_train_state(self.model, "adam", 1e-3)

    def train(self, dataset_dir, logdir, epochs=None, batch_size=None,
              val_fraction=0.2):
        """model.fit over the directory dataset; keeps the best-val-loss
        checkpoint at `{logdir}/best_model.ckpt` (the family's
        save-best-only policy, train_ISPRS.py:291-292). Returns the
        history."""
        from .data.dataset import DirectoryPairDataset
        from .losses import tanimoto_dual_loss
        from .train import make_eval_step, make_train_step
        from .train.loop import TrainConfig, train_model

        c = self.config
        ds = DirectoryPairDataset(
            os.path.join(dataset_dir, "train"),
            os.path.join(dataset_dir, "label"),
            c.CLASSES_NUM, mean=c.MEAN, target_size=(c.IMAGE_H, c.IMAGE_W))
        n = len(ds)
        order = np.random.default_rng(42).permutation(n)
        n_val = max(1, int(n * val_fraction)) if n > 1 else 0
        val_ds = ds.subset(order[:n_val]) if n_val else None
        train_ds = ds.subset(order[n_val:])

        loss_fns = {"seg": tanimoto_dual_loss}
        step = make_train_step(loss_fns, {}, False, device=self.device)
        eval_step = make_eval_step(loss_fns, {}, False, device=self.device)
        state = self._state or self._make_state()
        cfg = TrainConfig(epochs=epochs or c.EPOCHS,
                          batch_size=batch_size or c.BATCH_SIZE,
                          results_path=logdir, multitasking=False)
        self._state, history = train_model(cfg, state, step, eval_step,
                                           train_ds, val_ds or train_ds)
        return history

    def loadWeight(self, path):
        """model_old.py:176-177: restore the checkpoint train() saved,
        from its logdir (its best_model.ckpt) or the checkpoint
        directory itself."""
        from .train.checkpoint import restore

        best = os.path.join(path, "best_model.ckpt")
        self._state, _ = restore(best if os.path.isdir(best) else path,
                                 self._state or self._make_state())
        return self._state

    def predict(self, img):
        """model_old.py:179-185: one (H, W, C) image less the config MEAN,
        forward in eval mode, per-pixel argmax class ids (numpy)."""
        return self.model.predict_ids(img).cpu().numpy()

    def visual(self, result, path):
        """Render class ids with the ISPRS palette and save (test.py:17)."""
        from PIL import Image

        from .data.isprs import class_ids_to_rgb

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        Image.fromarray(class_ids_to_rgb(result)).save(path)
