"""Input normalization (resuneta_tpu/ops/normalize.py).

normalize_rgb, patch level (preprocess_save_patches_ISPRS.py:70-86):
  1: img / 255
  2: img / (127.5 - 1.), i.e. / 126.5: the reference's quirk, kept on
     purpose; it is NOT img / 127.5 - 1
  3: per-image StandardScaler over all pixels, per channel (biased std)

normalize_hsv, patch level (preprocess_save_patches_ISPRS.py:89-109), of
cv2's 8-bit HSV:
  1: * [1/179, 1/255, 1/255]
  2: * [1/(89.5 - 1), 1/(127.5 - 1), 1/(127.5 - 1)] (the same quirk)
  3: per-image StandardScaler

normalization, whole image (utils.py:242-253), numbered differently:
  1: StandardScaler, 2: MinMax to [0, 1], 3: MinMax to [-1, 1].

Both take NHWC-style arrays ([..., C]) and return float32 tensors on the
input's device.
"""

import torch


def _f32(img):
    return torch.as_tensor(img).to(torch.float32)


def standard_scale(img):
    """Per-channel standardization over every pixel (biased std; a zero std
    divides by 1)."""
    img = _f32(img)
    flat = img.reshape(-1, img.shape[-1])
    mean = flat.mean(dim=0)
    std = ((flat - mean) ** 2).mean(dim=0).sqrt()
    std = torch.where(std == 0, torch.ones_like(std), std)
    return ((flat - mean) / std).reshape(img.shape)


def minmax_scale(img, feature_range=(0.0, 1.0)):
    """Per-channel min-max scaling over every pixel."""
    img = _f32(img)
    lo, hi = feature_range
    flat = img.reshape(-1, img.shape[-1])
    mn = flat.min(dim=0).values
    mx = flat.max(dim=0).values
    rng = torch.where(mx - mn == 0, torch.ones_like(mx), mx - mn)
    return ((flat - mn) / rng * (hi - lo) + lo).reshape(img.shape)


def normalize_rgb(img, norm_type: int = 1):
    img = _f32(img)
    if norm_type == 1:
        return img / 255.0
    if norm_type == 2:
        return img / (127.5 - 1.0)
    if norm_type == 3:
        return standard_scale(img)
    raise ValueError(f"unknown norm_type {norm_type}")


def normalize_hsv(img, norm_type: int = 1):
    img = _f32(img)
    if norm_type == 1:
        scale = [1.0 / 179.0, 1.0 / 255.0, 1.0 / 255.0]
    elif norm_type == 2:
        scale = [1.0 / (89.5 - 1.0), 1.0 / (127.5 - 1.0), 1.0 / (127.5 - 1.0)]
    elif norm_type == 3:
        return standard_scale(img)
    else:
        raise ValueError(f"unknown norm_type {norm_type}")
    return img * torch.tensor(scale, dtype=torch.float32, device=img.device)


def normalization(image, norm_type: int = 1):
    if norm_type == 1:
        return standard_scale(image)
    if norm_type == 2:
        return minmax_scale(image, (0.0, 1.0))
    if norm_type == 3:
        return minmax_scale(image, (-1.0, 1.0))
    raise ValueError(f"unknown norm_type {norm_type}")
