from .norm import BatchNorm
from .resuneta import (Combine, Conv, ConvBN, PSPPooling, ResBlockA, ResUnetA,
                       UpSampleConv)
from .unet import UNet

__all__ = ["BatchNorm", "Combine", "Conv", "ConvBN", "PSPPooling",
           "ResBlockA", "ResUnetA", "UNet", "UpSampleConv"]
