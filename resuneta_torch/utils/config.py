"""The legacy class-based config (resuneta_tpu/utils/config.py; reference
ResUnet_a/config.py:3-19 UnetConfig): the defaults the legacy driver
(compat.UNet, cli/legacy_train.py) trains with."""

from dataclasses import dataclass, field
from typing import Sequence


@dataclass
class UnetConfig:
    MEAN: Sequence[float] = field(default_factory=lambda: [82.0, 92.0, 88.0])
    CLASSES_NUM: int = 5
    IMAGE_H: int = 512
    IMAGE_W: int = 512
    IMAGE_C: int = 3
    EPOCHS: int = 5000
    BATCH_SIZE: int = 8
    LOG_PATH: str = "./logs"

    def displayConfiguration(self):
        print("Configuration:")
        for name, value in self.__dict__.items():
            print(f"{name:30} {value}")
