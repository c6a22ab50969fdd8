"""The legacy Potsdam training driver of the port (the counterpart of
ResUnet_a/train.py, which drives resuneta_tpu.compat.UNet): the
size-adaptive legacy model (compat.UNet) trained with Adam(1e-3) and
Tanimoto over `{dataset}/train` and `{dataset}/label` image pairs, the best
checkpoint kept under the log directory.

    python -m resuneta_torch.cli.legacy_train [--device cpu]
        [--image_size 512] [--num_classes 5] [--epochs 5000]
        [--batch_size 8]

Environment overrides, as the reference's driver reads them:
RESUNETA_DATASET (default dataset-postdam), RESUNETA_LOGS (default logs).
The flags override UnetConfig's defaults (the reference's config.py);
without them it trains at 512 x 512 x 3, 5 classes, batch 8.
"""

import argparse
import os


def build_parser():
    from ..utils.config import UnetConfig

    c = UnetConfig()
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_size", type=int, default=c.IMAGE_W,
                        help="IMAGE_H = IMAGE_W of the config")
    parser.add_argument("--num_classes", type=int, default=c.CLASSES_NUM)
    parser.add_argument("--epochs", type=int, default=c.EPOCHS)
    parser.add_argument("--batch_size", type=int, default=c.BATCH_SIZE)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (raises without a card)")
    return parser


def config_from(args):
    """UnetConfig with the command line's overrides."""
    from ..utils.config import UnetConfig

    c = UnetConfig()
    c.IMAGE_H = c.IMAGE_W = args.image_size
    c.CLASSES_NUM = args.num_classes
    c.EPOCHS = args.epochs
    c.BATCH_SIZE = args.batch_size
    return c


def main(argv=None):
    """Train; returns the history."""
    from ..compat import UNet

    args = build_parser().parse_args(argv)
    config = config_from(args)
    config.displayConfiguration()
    unet = UNet(config=config, device=args.device)
    return unet.train(os.environ.get("RESUNETA_DATASET", "dataset-postdam"),
                      os.environ.get("RESUNETA_LOGS", "logs"))


if __name__ == "__main__":
    main()
