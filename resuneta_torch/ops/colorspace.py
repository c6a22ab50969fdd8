"""RGB <-> HSV in OpenCV's 8-bit convention, on the device
(resuneta_tpu/ops/colorspace.py:29-127).

The reference makes the colour head's labels with
cv2.cvtColor(img, cv2.COLOR_RGB2HSV) on uint8 patches (H in [0, 179], S and
V in [0, 255]) and normalises by [179, 255, 255]. `rgb_to_hsv_cv2` is
OpenCV's fixed-point arithmetic (hsv_shift = 12, round-half-even division
tables computed, not looked up) in exact int32, so it is bit-identical to
cv2 and to the JAX package. `hsv_to_rgb_cv2` is the test CLI's render of
the colour head (test_ISPRS.py:398-399, cv2.COLOR_HSV2RGB), in f32.
"""

import torch

from .normalize import normalize_hsv

_HSV_SHIFT = 12


def _round_div_half_even(num: int, den):
    """round(num / den), ties to even (cvRound), for a positive python-int
    numerator and an int32 tensor; den == 0 gives 0 (the tables' rule).
    Exact integer arithmetic."""
    den_safe = den.clamp_min(1)
    q = num // den_safe
    twice = 2 * (num - q * den_safe)
    q = q + (twice > den_safe).int() + ((twice == den_safe) & (q % 2 == 1)).int()
    return torch.where(den > 0, q, torch.zeros_like(q))


def rgb_to_hsv_cv2(rgb):
    """(..., 3) RGB with uint8 values -> cv2-style HSV as float32: H in
    [0, 180), S and V in [0, 255]."""
    rgb = rgb.to(torch.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    sdiv = _round_div_half_even(255 << _HSV_SHIFT, v)
    hdiv = _round_div_half_even((180 << _HSV_SHIFT) // 6, diff)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv + half) >> _HSV_SHIFT
    # OpenCV's branch order: v == r first, then v == g, then b
    h_num = torch.where(v == r, g - b,
                        torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h_num * hdiv + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.float32)


def hsv_to_rgb_cv2(hsv):
    """(..., 3) cv2-style HSV (H in [0, 180), S and V in [0, 255]) -> RGB
    in [0, 255], float32, in the reference's order of operations and
    branches (colorspace.py:79-102): the sector floor(H*2/60) % 6 picks
    the (r, g, b) of (c, x, 0) by OpenCV's table."""
    hsv = hsv.to(torch.float32)
    h = hsv[..., 0] * 2.0                       # degrees
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    zero = torch.zeros_like(c)
    idx = torch.floor(hp).to(torch.int32) % 6
    # the reference's select chain: sector -> (r, g, b)
    table = ((c, x, zero), (x, c, zero), (zero, c, x), (zero, x, c),
             (x, zero, c), (c, zero, x))
    rgb = []
    for ch in range(3):
        out = zero
        for k in range(5, -1, -1):
            out = torch.where(idx == k, table[k][ch], out)
        rgb.append(out + m)
    return torch.stack(rgb, dim=-1)


def standardize_per_sample(x):
    """Per-sample, per-channel standardisation of a (B, ..., C) batch
    (sklearn StandardScaler, biased std; a zero std divides by 1)."""
    x = x.float()
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    mean = flat.mean(dim=1, keepdim=True)
    std = ((flat - mean) ** 2).mean(dim=1, keepdim=True).sqrt()
    std = torch.where(std == 0, torch.ones_like(std), std)
    return ((flat - mean) / std).reshape(x.shape)


def hsv_color_label(rgb_u8, norm_type: int = 1):
    """The colour head's label of a (B, H, W, 3) uint8 batch: normalised
    HSV, float32 (preprocess_save_patches_ISPRS.py:89-109, 223-228),
    including norm_type 2's divide by 88.5/126.5 (the reference's quirk,
    kept) and norm_type 3's per-sample standardisation."""
    hsv = rgb_to_hsv_cv2(rgb_u8)
    if norm_type == 3:
        return standardize_per_sample(hsv)
    return normalize_hsv(hsv, norm_type)
