from .norm import BatchNorm
from .resnet50_unet import IdentityBlock, ResNet50UNet
from .resuneta import (Combine, Conv, ConvBN, PSPPooling, ResBlockA, ResUnetA,
                       UpSampleConv)
from .unet import UNet
from .variants import (PSPPoolingLegacy, PSPPoolingV1, ResBlockV1,
                       ResUnetALegacy, ResUnetAV1)

__all__ = ["BatchNorm", "Combine", "Conv", "ConvBN", "IdentityBlock",
           "PSPPooling", "PSPPoolingLegacy", "PSPPoolingV1", "ResBlockA",
           "ResBlockV1", "ResNet50UNet", "ResUnetA", "ResUnetALegacy",
           "ResUnetAV1", "UNet", "UpSampleConv"]
