"""The legacy Potsdam testing driver of the port (the counterpart of
ResUnet_a/test.py): restore the best checkpoint from the train driver's
log directory, predict every image under `{dataset}/test` (decodable
images or .npy arrays, sorted by name) resized to the config's size (mean
subtraction, argmax; ResUnet_a/model_old.py:176-185) and render each class
map with the ISPRS palette to `{out}/{i}.png`.

    python -m resuneta_torch.cli.legacy_test [--device cpu]
        [--image_size 512] [--num_classes 5]

Environment overrides: RESUNETA_DATASET (default ./dataset-postdam),
RESUNETA_LOGS (default ./logs), RESUNETA_OUT (default ./test-result). The
flags are legacy_train's, and must match the training run's.
"""

import os

from .legacy_train import build_parser, config_from


def main(argv=None):
    """Predict and render; returns the class maps in file order."""
    from ..compat import UNet
    from ..data.dataset import _load_any, _resize_bilinear

    args = build_parser().parse_args(argv)
    config = config_from(args)
    unet = UNet(config=config, device=args.device)
    unet.loadWeight(os.environ.get("RESUNETA_LOGS", "./logs"))
    dataset = os.environ.get("RESUNETA_DATASET", "./dataset-postdam")
    out = os.environ.get("RESUNETA_OUT", "./test-result")
    results = []
    for index, name in enumerate(sorted(os.listdir(
            os.path.join(dataset, "test")))):
        img = _load_any(os.path.join(dataset, "test", name))
        img = _resize_bilinear(img, config.IMAGE_H, config.IMAGE_W)
        result = unet.predict(img)
        unet.visual(result, os.path.join(out, f"{index}.png"))
        results.append(result)
    return results


if __name__ == "__main__":
    main()
