"""PyTorch + CUDA port of resuneta_tpu for NVIDIA Hopper (H100).

The JAX package `resuneta_tpu` is the reference; this package computes the
same functions with PyTorch and hand-written CUDA kernels. It never imports
JAX, Flax or anything of `resuneta_tpu`.

Public layouts follow the reference (NHWC). Entry points take `device=None`,
which means "cuda" and raises when no card is present; pass `device="cpu"`
to run the plain PyTorch path.

Ported so far:
- ISPRS sliding-window inference of the multitask ResUnet-a d6
  (`infer.sliding`, `cli.test_isprs`), with the fused BN -> ReLU -> dilated
  3x3 conv segment as a CUDA kernel (`ops.convseg`, K1);
- the ISPRS multitask train step (`train.make_train_step` with
  `data.make_device_pipeline`, `losses`, `train.create_train_state`), with
  the segment's backward (K2), the JFA distance transform (`ops.distance`,
  K5) and the Canny boundary labels (`ops.boundary`, K6) as CUDA kernels,
  in both of the reference's routings: NHWC, and the dense trunk (the
  default on the card), whose 1x1 convs over concat parts (`ops.densemm`,
  K3) and PSP max pool -> 1x1 conv (`ops.poolconv`, K4) are CUDA kernels;
- the training runtime above the step: packed datasets with a native row
  gather (`data.dataset`, `data.native_loader`), the epoch loop and
  checkpoints (`train.loop`, `train.checkpoint`), the UNet baseline
  (`models.unet`) and the train CLI (`cli.train_isprs`);
- the ISPRS preprocess CLI (`cli.preprocess_isprs`) and the Amazon
  deforestation workload: its dataset build (`data.amazon`,
  `ops.morphology`), whole-scene eval (`infer.amazon`) and CLIs
  (`cli.preprocess_amazon`, `cli.train_amazon`, `cli.test_amazon`);
- data-parallel training and inference, one process a card over
  torch.distributed (`parallel`: sync-BN, the Tanimoto volumes, the
  gradient mean and the metric counts reduced over the ranks; the train
  CLIs' `--gpu_parallel` and torchrun; the sharded patch grid and
  overlap inference);
- the rest of the model family (`models.ResUnetAV1`, `ResUnetALegacy`,
  `ResNet50UNet`), the Keras-shaped `compat.Resunet_a` and the legacy
  driver `compat.UNet` with its CLIs (`cli.legacy_train`,
  `cli.legacy_test`, `utils.config.UnetConfig`, `data.legacy_utils`), the
  test CLI's multitask figures (`cli.test_isprs`, K5 and K6 on its
  reference planes) and the rematerialised train step
  (`train.make_train_step(remat=True)`).
"""

__version__ = "0.1.0"
