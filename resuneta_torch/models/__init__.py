from .norm import BatchNorm
from .resuneta import (Combine, Conv, ConvBN, PSPPooling, ResBlockA, ResUnetA,
                       UpSampleConv)

__all__ = ["BatchNorm", "Combine", "Conv", "ConvBN", "PSPPooling",
           "ResBlockA", "ResUnetA", "UpSampleConv"]
