"""Seeded inputs, made on the device in bulk.

- Class maps: Voronoi regions of a jittered grid of seeds, one seed per
  grid cell of `cell` pixels, each pixel taking the class of the nearest
  of the 9 seeds around its cell. Region classes are drawn with the given
  shares.
- RGB images of a class map: a colour per class, an offset per region
  and noise per pixel, as uint8.
- The Amazon traffic's 14-band patches: two smooth fields, thresholded per
  patch at their quantiles, make the deforestation (class 1) and past
  deforestation (class 2) blobs; the bands are smooth noise with a shift
  per class.
"""

import math

import torch
import torch.nn.functional as F

# the ISPRS palette's colours of the 5 classes (impervious, building, low
# vegetation, tree, car)
PALETTE = ((255, 255, 255), (0, 0, 255), (0, 255, 255), (0, 255, 0),
           (255, 255, 0))


def _chunks(n, step):
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def voronoi(n, H, W, cell, share, gen, device):
    """(class ids (n, H, W) uint8, region ids (n, H, W) int64)."""
    gh, gw = math.ceil(H / cell) + 2, math.ceil(W / cell) + 2
    jitter = torch.rand((n, gh, gw, 2), generator=gen, device=device)
    sy = (torch.arange(-1, gh - 1, device=device)[:, None] +
          jitter[..., 0]) * cell
    sx = (torch.arange(-1, gw - 1, device=device)[None, :] +
          jitter[..., 1]) * cell
    probs = torch.tensor(share, dtype=torch.float32, device=device)
    cls = torch.multinomial(probs, n * gh * gw, replacement=True,
                            generator=gen).view(n, gh, gw).to(torch.uint8)
    ids = torch.empty((n, H, W), dtype=torch.uint8, device=device)
    regions = torch.empty((n, H, W), dtype=torch.int64, device=device)
    xs = torch.arange(W, device=device)
    # about 2^22 pixels a chunk: whole images, or bands of rows of one
    per = max(1, (1 << 22) // (H * W))
    rows = H if per > 1 else max(1, (1 << 22) // W)
    for i0, i1 in _chunks(n, per):
        img = torch.arange(i0, i1, device=device)[:, None, None]
        for r0, r1 in _chunks(H, rows):
            ys = torch.arange(r0, r1, device=device)
            cy = (ys // cell + 1)[None, :, None]
            cx = (xs // cell + 1)[None, None, :]
            best = by = bx = None
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    gy = (cy + di).expand(i1 - i0, -1, W)
                    gx = (cx + dj).expand(i1 - i0, r1 - r0, -1)
                    d = (sy[img, gy, gx] - ys[None, :, None]) ** 2 + \
                        (sx[img, gy, gx] - xs[None, None, :]) ** 2
                    if best is None:
                        best, by, bx = d, gy, gx
                    else:
                        take = d < best
                        best = torch.where(take, d, best)
                        by = torch.where(take, gy, by)
                        bx = torch.where(take, gx, bx)
            ids[i0:i1, r0:r1] = cls[img, by, bx]
            regions[i0:i1, r0:r1] = (img * gh + by) * gw + bx
    return ids, regions


def rgb(ids, regions, gen, device):
    """(n, H, W, 3) uint8 images of class maps."""
    pal = torch.tensor(PALETTE, dtype=torch.float32, device=device)
    offset = torch.randn((int(regions.max()) + 1, 3), generator=gen,
                         device=device) * 20.0
    n, H, W = ids.shape
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    per = max(1, (1 << 22) // (H * W))
    rows = H if per > 1 else max(1, (1 << 22) // W)
    for i0, i1 in _chunks(n, per):
        for r0, r1 in _chunks(H, rows):
            c = ids[i0:i1, r0:r1].long()
            noise = torch.randn(c.shape + (3,), generator=gen,
                                device=device) * 10.0
            px = pal[c] * 0.6 + 50.0 + offset[regions[i0:i1, r0:r1]] + noise
            out[i0:i1, r0:r1] = px.round().clamp(0, 255).to(torch.uint8)
    return out


def _smooth(n, P, grid, gen, device):
    low = torch.randn((n, 1, grid, grid), generator=gen, device=device)
    return F.interpolate(low, size=(P, P), mode="bilinear",
                         align_corners=False)[:, 0]


def _quantile(f, q):
    """Per row, the value at rank q of its sorted values."""
    k = min(int(q * f.shape[1]), f.shape[1] - 1)
    return f.sort(dim=1).values[:, k:k + 1]


def amazon(n, P, bands, share1, share2, gen, device):
    """(image (n, P, P, bands) float32, one-hot (n, P, P, 3) float32)."""
    f1 = _smooth(n, P, 8, gen, device).flatten(1)
    f2 = _smooth(n, P, 8, gen, device).flatten(1)
    q1 = _quantile(f1, 1.0 - share1)
    q2 = _quantile(f2, 1.0 - share2)
    ids = torch.zeros_like(f1, dtype=torch.long)
    ids = torch.where(f2 >= q2, torch.full_like(ids, 2), ids)
    ids = torch.where(f1 >= q1, torch.ones_like(ids), ids)
    ids = ids.view(n, P, P)
    shift = torch.randn((3, bands), generator=gen, device=device) * 0.5
    image = torch.empty((n, P, P, bands), dtype=torch.float32, device=device)
    for b in range(bands):
        image[..., b] = _smooth(n, P, 16, gen, device) * 0.7 + \
            torch.randn((n, P, P), generator=gen, device=device) * 0.3
    image += shift[ids]
    return image, F.one_hot(ids, 3).float()
