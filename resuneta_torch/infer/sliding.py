"""Sliding-window whole-scene inference (resuneta_tpu/infer/sliding.py).

Reference flow (test_ISPRS.py:268-333): non-overlapping chop -> predict ->
argmax -> row-major reconstruction. Patches go through the model in
batches; the production path (`make_seg_ids_fn`) uploads uint8 pixels,
normalizes and argmaxes on the device and brings back uint8 ids only.

`predict_patches`, `predict_scene` and `predict_scene_overlap` take
`group=` (a parallel.mesh.DataGroup; the reference's `mesh`,
sliding.py:124-263): every rank calls them with the same patches and
apply_fn on its own card, each batch of the patch grid is sharded over the
ranks, and the ranks' host outputs are gathered, so every rank returns
what one rank would. Over a SpaceMesh the patches shard over its data axis
and the ranks of a space axis run the same rows, as the reference runs a
mesh with a 'space' axis (sliding.py:134-156); each forward runs on whole
patches, no height is sharded, so the kernels stay live.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..parallel.mesh import shard_batch
from ..ops.normalize import normalize_rgb
from ..ops.patches import extract_patches_nonoverlap, reconstruct_from_patches


def seg_ids_u8(out):
    """On-device post head: uint8 class ids of the seg probabilities (a dict
    or a tensor), or the ids themselves when `out` already holds integer
    ids (the output of a `make_seg_ids_fn` function)."""
    seg = out["seg"] if isinstance(out, dict) else out
    if not seg.is_floating_point():
        return seg.to(torch.uint8)
    return seg.argmax(dim=-1).to(torch.uint8)


def seg_ids_prob1(out):
    """On-device post head of the Amazon whole-scene eval
    (utils.py:505-546): uint8 class ids and the f16 class-1 probability
    plane, which is all that eval reads (~8x less copied than the f32
    probability volumes of every head)."""
    seg = out["seg"] if isinstance(out, dict) else out
    return {"ids": seg.argmax(dim=-1).to(torch.uint8),
            "prob1": seg[..., 1].to(torch.float16)}


def seg_prob1_f16(out):
    """On-device post head: the f16 class-1 probability plane alone."""
    seg = out["seg"] if isinstance(out, dict) else out
    return seg[..., 1].to(torch.float16)


def _to_host(out):
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out.cpu().numpy()


def make_apply_fn(model, device=None):
    """Inference-mode forward on `device` (None means cuda): takes NHWC
    patches (numpy or tensor), returns the model's NHWC outputs on the
    device."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def apply_fn(x):
        return model(torch.as_tensor(x).to(dev))
    return apply_fn


def make_seg_ids_fn(model, multitask=True, norm_type=None, device=None):
    """Forward that returns uint8 class ids, argmaxed on the device. With
    norm_type set, the input is raw uint8 pixels, uploaded as uint8 (4x less
    traffic than f32) and normalized on the device."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def fn(x):
        x = torch.as_tensor(x).to(dev)
        if norm_type is not None:
            x = normalize_rgb(x, norm_type)
        out = model(x)
        seg = out["seg"] if multitask else out
        return seg.argmax(dim=-1).to(torch.uint8)
    return fn


def _gather(out, group):
    """The ranks' host outputs (equal shapes) concatenated in rank order
    along the batch, on every rank, over the group's gloo channel."""
    def cat(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(group.size)]
        dist.all_gather(parts, t, group=group.host)
        return torch.cat(parts).numpy()

    if isinstance(out, dict):
        return {k: cat(v) for k, v in out.items()}
    return cat(out)


def _padded(chunk, batch_size):
    """A tail chunk padded to batch_size rows by repeating its last patch,
    and the count of pads."""
    pad = batch_size - chunk.shape[0]
    if pad:
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
    return chunk, pad


def predict_patches(apply_fn, patches, batch_size=32, device_post=None,
                    group=None):
    """Run apply_fn over (N, P, P, C) patches in batches of batch_size,
    padding the tail batch by repeating its last patch. device_post reduces
    each batch on the device before the copy to the host. With `group`,
    the batch size is rounded to a multiple of the ranks (at least one row
    each, as the reference does, sliding.py:136-140) and each rank runs its
    rows of every batch; all ranks return the whole result. Returns numpy:
    a dict of arrays for multitask outputs, else an array. A SpaceMesh's
    batch rounds to a multiple of all its ranks and its rows shard over the
    data axis (module doc)."""
    n = patches.shape[0]
    if group is not None:
        batch_size = max(batch_size // group.size, 1) * group.size
    rows = getattr(group, "data", group)
    outs = []
    for i in range(0, n, batch_size):
        chunk, pad = _padded(patches[i:i + batch_size], batch_size)
        out = apply_fn(np.ascontiguousarray(shard_batch(chunk, group)))
        if device_post is not None:
            out = device_post(out)
        out = _to_host(out)
        if group is not None:
            out = _gather(out, rows)
        if pad:
            out = {k: v[:-pad] for k, v in out.items()} \
                if isinstance(out, dict) else out[:-pad]
        outs.append(out)
    if isinstance(outs[0], dict):
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return np.concatenate(outs)


def predict_scene(apply_fn, image, patch_size, batch_size=32, multitask=True,
                  ids_only=False, group=None):
    """Whole-scene segmentation: chop -> predict -> argmax -> reconstruct.
    Returns (class_map (H', W'), the raw patch predictions, or uint8 patch
    ids when ids_only, argmaxed on the device). `group` as in
    predict_patches."""
    image = np.asarray(image)
    patches = extract_patches_nonoverlap(image, patch_size, order="row")
    if ids_only:
        preds = predict_patches(apply_fn, patches, batch_size,
                                device_post=seg_ids_u8, group=group)
        seg_ids = preds
    else:
        preds = predict_patches(apply_fn, patches, batch_size, group=group)
        seg = preds["seg"] if multitask else preds
        seg_ids = np.argmax(seg, axis=-1)
    class_map = reconstruct_from_patches(seg_ids, image.shape[0],
                                         image.shape[1], order="row")
    return np.asarray(class_map), preds


def _grid_starts(extent, patch_size, stride):
    """Start offsets covering [0, extent) with the last window edge-clamped."""
    starts = list(range(0, extent - patch_size + 1, stride))
    if starts[-1] != extent - patch_size:
        starts.append(extent - patch_size)
    return starts


def _seg_probs_f32(out):
    """On-device post head: the f32 seg probabilities (a dict or a
    tensor)."""
    return (out["seg"] if isinstance(out, dict) else out).float()


def predict_scene_overlap(apply_fn, image, patch_size, stride, batch_size=32,
                          multitask=True, group=None):
    """Overlap-averaged whole-scene segmentation: windows every `stride`
    pixels, their seg softmax summed into a scene canvas in window order,
    the class map the argmax of the mean. The scene is cropped to
    patch_size multiples first, so stride == patch_size is the plain chop.
    Without a group the canvas stays on the device. With `group` (the
    reference's mesh=, sliding.py:173) the windows go through
    predict_patches(group=), each rank forwarding its rows of every batch,
    and every rank folds the gathered probabilities on the host in the
    same window order: the same f32 sums, so each returns what one
    process returns from the same forward batches. Returns (class_map
    (H', W') uint8, mean probabilities (H', W', C))."""
    image = np.asarray(image)
    Hc = image.shape[0] // patch_size * patch_size
    Wc = image.shape[1] // patch_size * patch_size
    image = image[:Hc, :Wc]
    positions = [(y, x) for y in _grid_starts(Hc, patch_size, stride)
                 for x in _grid_starts(Wc, patch_size, stride)]
    patches = np.stack([image[y:y + patch_size, x:x + patch_size]
                        for y, x in positions])

    if group is not None:
        probs = predict_patches(apply_fn, patches, batch_size,
                                device_post=_seg_probs_f32, group=group)
        batches = [(torch.from_numpy(probs), positions)]
    else:
        # the tail batch padded as predict_patches pads it: the same
        # forward batches as a group's
        batches = ((_seg_probs_f32(apply_fn(np.ascontiguousarray(
            _padded(patches[i:i + batch_size], batch_size)[0]))),
                    positions[i:i + batch_size])
                   for i in range(0, len(patches), batch_size))
    canvas = count = None
    for probs, pos in batches:
        if canvas is None:
            canvas = torch.zeros((Hc, Wc, probs.shape[-1]),
                                 dtype=torch.float32, device=probs.device)
            count = torch.zeros((Hc, Wc), dtype=torch.float32,
                                device=probs.device)
        for p, (y, x) in zip(probs, pos):
            canvas[y:y + patch_size, x:x + patch_size] += p
            count[y:y + patch_size, x:x + patch_size] += 1.0
    mean = (canvas / count[..., None]).cpu().numpy()
    return np.argmax(mean, axis=-1).astype(np.uint8), mean
