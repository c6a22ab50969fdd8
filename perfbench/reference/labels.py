"""The reference's input pipeline: from the raw batch the benchmark made to
the model's input and its four label heads, in plain PyTorch.

- Augmentation: the upstream's five variants (utils.py data_augmentation):
  0 identity, 1 np.rot90 of the spatial axes, 2 rot180, 3 flip of axis 0,
  4 flip of axis 1.
- Boundary (multitasking_utils.get_boundary_label): OpenCV's
  Canny(plane, 0, 1) on every class plane, then a 3x3 cross dilation. On
  one-hot planes Sobel's |dx| + |dy| is even, so no pixel is weak and the
  hysteresis keeps exactly the strong pixels: Sobel with a replicated
  border, the L1 magnitude, OpenCV's non-maximum suppression (tan 22.5
  as 13573 / 2^15, its tie rules, zero magnitude outside the plane) and
  magnitude > 1.
- Distance (get_distance_label): cv2.distanceTransform(DIST_L2, 0), the
  exact Euclidean distance of each nonzero pixel to the nearest zero one,
  then min-max to [0, 1] per plane (an all-equal plane gives 0). Computed
  exactly by rows then columns (the lower envelope taken by brute force),
  not by jump flooding.
- Colour (preprocess_save_patches_ISPRS.py): cv2.cvtColor RGB2HSV in
  OpenCV's 8-bit fixed point, divided by (179, 255, 255).
"""

import torch
import torch.nn.functional as F

INF = float("inf")


def augment(x, variants):
    """x: (B, H, W, ...); variants: (B,) ints in [0, 5)."""
    out = []
    for xi, v in zip(x, [int(v) for v in variants]):
        if v == 1:
            xi = torch.rot90(xi, 1, dims=(0, 1))
        elif v == 2:
            xi = torch.rot90(xi, 2, dims=(0, 1))
        elif v == 3:
            xi = torch.flip(xi, dims=(0,))
        elif v == 4:
            xi = torch.flip(xi, dims=(1,))
        out.append(xi)
    return torch.stack(out)


def _shift(a, di, dj, fill):
    """out[..., i, j] = a[..., i + di, j + dj], `fill` outside."""
    H, W = a.shape[-2:]
    out = torch.full_like(a, fill)
    out[..., max(-di, 0):H - max(di, 0), max(-dj, 0):W - max(dj, 0)] = \
        a[..., max(di, 0):H + min(di, 0), max(dj, 0):W + min(dj, 0)]
    return out


def boundary(planes):
    """(P, H, W) {0, 1} int planes -> (P, H, W) float32 {0, 1}."""
    img = planes.to(torch.int32)
    p = F.pad(img[:, None].float(), (1, 1, 1, 1), mode="replicate")[:, 0]
    p = p.to(torch.int32)
    sm_rows = p[:, :-2, :] + 2 * p[:, 1:-1, :] + p[:, 2:, :]
    dx = sm_rows[:, :, 2:] - sm_rows[:, :, :-2]
    sm_cols = p[:, :, :-2] + 2 * p[:, :, 1:-1] + p[:, :, 2:]
    dy = sm_cols[:, 2:, :] - sm_cols[:, :-2, :]
    mag = dx.abs() + dy.abs()

    def m(di, dj):
        return _shift(mag, di, dj, 0)

    ax = dx.abs()
    tg22 = ax * 13573
    tg67 = tg22 + ((ax + ax) << 15)
    ay = dy.abs() << 15
    horiz, vert = ay < tg22, ay > tg67
    keep_h = (mag > m(0, -1)) & (mag >= m(0, 1))
    keep_v = (mag > m(-1, 0)) & (mag >= m(1, 0))
    diag = torch.where((dx ^ dy) < 0,
                       (mag > m(-1, 1)) & (mag > m(1, -1)),
                       (mag > m(-1, -1)) & (mag > m(1, 1)))
    kept = torch.where(horiz, keep_h, torch.where(vert, keep_v, diag))
    edges = kept & (mag > 1)
    grown = edges | _shift(edges, 0, -1, False) | _shift(edges, 0, 1, False) \
        | _shift(edges, -1, 0, False) | _shift(edges, 1, 0, False)
    return grown.float()


def distance(planes, chunk=8):
    """(P, H, W) planes -> (P, H, W) float32: the exact Euclidean distance
    of each nonzero pixel to the nearest zero pixel, min-max normalised per
    plane."""
    P, H, W = planes.shape
    dev = planes.device
    out = torch.empty((P, H, W), dtype=torch.float32, device=dev)
    cols = torch.arange(W, device=dev, dtype=torch.float32)
    rows = torch.arange(H, device=dev, dtype=torch.float32)
    dr2 = (rows[:, None] - rows[None, :]) ** 2          # (H, H)
    for s in range(0, P, chunk):
        zero = planes[s:s + chunk] == 0                 # the seeds
        # along each row: the distance to the nearest seed left or right
        pos = torch.where(zero, cols, torch.full_like(cols, -INF))
        left = cols - torch.cummax(pos, dim=-1).values
        posr = torch.where(zero, cols, torch.full_like(cols, INF))
        right = torch.flip(torch.cummin(torch.flip(posr, (-1,)), dim=-1)
                           .values, (-1,)) - cols
        g2 = torch.minimum(left, right) ** 2            # (p, H, W)
        # down each column: min over rows k of g2[k, j] + (i - k)^2
        d2 = (g2[:, None, :, :] + dr2[None, :, :, None]).amin(dim=2)
        d = torch.sqrt(d2)
        has_seed = zero.flatten(1).any(dim=1)
        d = torch.where(has_seed[:, None, None], d, torch.zeros_like(d))
        mn = d.amin(dim=(1, 2), keepdim=True)
        mx = d.amax(dim=(1, 2), keepdim=True)
        rng = mx - mn
        ok = rng > 0
        out[s:s + chunk] = torch.where(
            ok, (d - mn) / torch.where(ok, rng, torch.ones_like(rng)),
            torch.zeros_like(d))
    return out


def _round_div_half_even(num, den):
    den_safe = den.clamp_min(1)
    q = num // den_safe
    twice = 2 * (num - q * den_safe)
    q = q + (twice > den_safe).int() + \
        ((twice == den_safe) & (q % 2 == 1)).int()
    return torch.where(den > 0, q, torch.zeros_like(q))


def hsv(rgb_u8):
    """(..., 3) uint8 RGB -> (..., 3) float32 OpenCV HSV / (179, 255,
    255)."""
    rgb = rgb_u8.to(torch.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    shift = 12
    sdiv = _round_div_half_even(255 << shift, v)
    hdiv = _round_div_half_even((180 << shift) // 6, diff)
    half = 1 << (shift - 1)
    s = (diff * sdiv + half) >> shift
    h_num = torch.where(v == r, g - b,
                        torch.where(v == g, b - r + 2 * diff,
                                    r - g + 4 * diff))
    h = (h_num * hdiv + half) >> shift
    h = torch.where(h < 0, h + 180, h)
    out = torch.stack([h, s, v], dim=-1).float()
    return out * torch.tensor([1.0 / 179.0, 1.0 / 255.0, 1.0 / 255.0],
                              device=out.device)


def heads_from_onehot(onehot):
    """The boundary and distance labels of a (B, H, W, C) one-hot batch."""
    B, H, W, C = onehot.shape
    planes = onehot.permute(0, 3, 1, 2).reshape(B * C, H, W)
    bound = boundary((planes != 0).to(torch.int32))
    dist = distance(planes)

    def back(t):
        return t.reshape(B, C, H, W).permute(0, 2, 3, 1)

    return back(bound), back(dist)


def isprs_batch(image_u8, label_ids, variants, num_classes):
    """The model's batch of the ISPRS training traffic: normalised image
    (/255) and the seg, bound, dist and color labels."""
    img = augment(image_u8, variants)
    ids = augment(label_ids, variants)
    onehot = F.one_hot(ids.long(), num_classes).float()
    bound, dist = heads_from_onehot(onehot)
    return {"image": img.float() / 255.0, "seg": onehot, "bound": bound,
            "dist": dist, "color": hsv(img)}


def amazon_batch(image, onehot):
    """The model's batch of the Amazon training traffic: the image as it is
    and the seg, bound and dist labels from the one-hot."""
    bound, dist = heads_from_onehot(onehot)
    return {"image": image.float(), "seg": onehot.float(), "bound": bound,
            "dist": dist}
