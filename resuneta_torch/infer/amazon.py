"""Amazon whole-scene evaluation (resuneta_tpu/infer/amazon.py): the
prediction() chain of utils.py:505-546 (column-major non-overlap chop,
batched forward, class-1 probability map, reconstruction, area opening
that drops predicted blobs under `area` pixels, past-deforestation and
border masking, the considered pixels flattened), the threshold sweep of
utils2.py:312-356 and the TP/FP/FN colour map (utils.py:549-563).

`apply_fn` is an inference forward such as infer.sliding.make_apply_fn's:
NHWC patches in, the model's outputs as tensors on its device out. The
forward and the reduction to ids and the class-1 plane run on that device;
the rest is host numpy. `group=` (a parallel.mesh.DataGroup; the JAX
package's `mesh`, amazon.py:16-127) passes through to predict_patches:
every rank calls these with its own apply_fn, the patch grid is sharded
over the ranks, and every rank returns the whole result.
"""

import time

import numpy as np

from ..data.amazon import extract_patches_right_region_prediction
from ..ops.morphology import area_opening
from ..ops.patches import extract_patches_nonoverlap, reconstruct_from_patches
from .sliding import predict_patches, seg_ids_prob1, seg_prob1_f16


def _seg_ids_probs(apply_fn, patch_ts, batch_size, full_probs, group):
    """Batched forward -> (class ids, class-1 probabilities). By default
    the ids (uint8) and the class-1 plane (f16) are reduced on the device
    before the copy to the host (seg_ids_prob1); full_probs=True copies
    the f32 probability volumes, as the reference's flow does."""
    if full_probs:
        preds = predict_patches(apply_fn, patch_ts, batch_size=batch_size,
                                group=group)
        seg = preds["seg"] if isinstance(preds, dict) else preds
        return np.argmax(seg, axis=-1), seg[..., 1]
    out = predict_patches(apply_fn, patch_ts, batch_size=batch_size,
                          device_post=seg_ids_prob1, group=group)
    return out["ids"], out["prob1"].astype(np.float32)


def prediction(apply_fn, image_array, image_ref, final_mask, mask_amazon_ts,
               patch_size, area, batch_size=32, full_probs=False,
               group=None):
    """Returns (ref_final, pre_final, prob_reconstructed, ref_reconstructed,
    ref_clip, clipping_mask, test_time) — the tuple of utils.py:505-546."""
    H, W = image_ref.shape

    patch_ts = extract_patches_nonoverlap(image_array, patch_size, order="col")
    patches_lb = extract_patches_nonoverlap(image_ref, patch_size, order="col")
    clipping_ref = extract_patches_nonoverlap(final_mask, patch_size, order="col")

    start_test = time.time()
    p_labels, probs = _seg_ids_probs(apply_fn, patch_ts.astype(np.float32),
                                     batch_size, full_probs, group)
    end_test = time.time() - start_test

    ref_reconstructed = reconstruct_from_patches(patches_lb, H, W, order="col")
    img_reconstructed = reconstruct_from_patches(p_labels, H, W, order="col")
    prob_reconstructed = reconstruct_from_patches(probs, H, W, order="col")
    ref_clip = reconstruct_from_patches(clipping_ref, H, W, order="col")

    clipping_mask_p = extract_patches_nonoverlap(mask_amazon_ts, patch_size,
                                                 order="col")
    clipping_mask = reconstruct_from_patches(clipping_mask_p, H, W, order="col")

    # Exclude predicted deforestation blobs smaller than `area` pixels
    mask_areas_pred = np.ones_like(ref_reconstructed)
    area_kept = area_opening(img_reconstructed.astype(np.int32),
                             area_threshold=area, connectivity=1)
    area_no_consider = img_reconstructed - area_kept
    mask_areas_pred[area_no_consider == 1] = 0

    # Mask out past deforestation (class 2) regions
    mask_borders = np.ones_like(img_reconstructed)
    mask_borders[ref_clip == 2] = 0

    mask_no_consider = mask_areas_pred * mask_borders
    ref_consider = mask_no_consider * ref_clip
    pred_consider = mask_no_consider * img_reconstructed

    sel = clipping_mask * mask_no_consider == 1
    ref_final = ref_consider[sel]
    pre_final = pred_consider[sel]

    return (ref_final, pre_final, prob_reconstructed, ref_reconstructed,
            ref_clip, clipping_mask, end_test)


def prediction2(apply_fn, image_array, image_ref, final_mask, mask_amazon_ts,
                patch_size, area, batch_size=32, full_probs=False,
                group=None):
    """utils2.py:370-417: like prediction() but patches come from
    extract_patches_right_region_prediction (only fully-valid patches, stride =
    patch_size) — suitable when the raster footprint excludes border regions.
    Reconstruction requires the valid patches to tile the full grid (the reference
    silently returns a scrambled image otherwise, utils2.py:370-417); here a
    non-tiling patch set raises instead."""
    H, W = image_ref.shape
    patch_ts, patches_lb, _, _ = extract_patches_right_region_prediction(
        image_array, image_ref, mask_amazon_ts, final_mask, patch_size,
        stride=patch_size)
    n_grid = (H // patch_size) * (W // patch_size)
    if len(patch_ts) != n_grid:
        raise ValueError(
            f"prediction2: only {len(patch_ts)} of {n_grid} grid patches are "
            "fully valid (reference contains -1 pixels) — reconstruction would "
            "be misaligned. Use prediction() for rasters with invalid regions.")
    patch_ts = np.asarray(patch_ts, np.float32)
    patches_lb = np.asarray(patches_lb)

    start_test = time.time()
    p_labels, probs = _seg_ids_probs(apply_fn, patch_ts, batch_size,
                                     full_probs, group)
    end_test = time.time() - start_test

    ref_reconstructed = reconstruct_from_patches(patches_lb, H, W, order="col")
    img_reconstructed = reconstruct_from_patches(p_labels, H, W, order="col")
    prob_reconstructed = reconstruct_from_patches(probs, H, W, order="col")
    return (img_reconstructed, prob_reconstructed, ref_reconstructed, end_test)


def output_prediction_FC(apply_fn, image_array, final_mask, patch_size,
                         batch_size=32, full_probs=False, group=None):
    """utils2.py:304-310: probability-map-only whole-scene prediction (class-1
    probs reduced to f16 on device by default; full_probs keeps f32 volumes)."""
    start_test = time.time()
    patch_ts = extract_patches_nonoverlap(image_array, patch_size, order="col")
    if full_probs:
        preds = predict_patches(apply_fn, patch_ts.astype(np.float32),
                                batch_size=batch_size, group=group)
        seg = preds["seg"] if isinstance(preds, dict) else preds
        probs = seg[..., 1]
    else:
        probs = predict_patches(apply_fn, patch_ts.astype(np.float32),
                                batch_size=batch_size,
                                device_post=seg_prob1_f16,
                                group=group).astype(np.float32)
    end_test = time.time() - start_test
    H, W = final_mask.shape[:2]
    prob_reconstructed = reconstruct_from_patches(probs, H, W, order="col")
    return prob_reconstructed, end_test


def matrics_AA_recall(thresholds, prob_map, reference, mask_amazon_ts, area):
    """utils2.py:312-356 (repaired imports): per-threshold binarization with area
    opening + past-deforestation masking, returning rows of
    (recall, precision, alarm-area) fractions like the reference."""
    metrics_all = []
    for thr in thresholds:
        img_reconstructed = (prob_map >= thr).astype(np.float64)

        mask_areas_pred = np.ones_like(reference, np.float64)
        kept = area_opening(img_reconstructed.astype(np.int32),
                            area_threshold=area, connectivity=1)
        area_no_consider = img_reconstructed - kept
        mask_areas_pred[area_no_consider == 1] = 0

        mask_borders = np.ones_like(img_reconstructed)
        mask_borders[reference == 2] = 0

        mask_no_consider = mask_areas_pred * mask_borders
        ref_consider = mask_no_consider * reference
        pred_consider = mask_no_consider * img_reconstructed

        ref_final = ref_consider[mask_amazon_ts == 1]
        pre_final = pred_consider[mask_amazon_ts == 1]

        tp = float(np.sum((pre_final == 1) & (ref_final == 1)))
        fp = float(np.sum((pre_final == 1) & (ref_final != 1)))
        fn = float(np.sum((pre_final != 1) & (ref_final == 1)))
        precision_ = tp / max(tp + fp, 1e-12)
        recall_ = tp / max(tp + fn, 1e-12)
        aa = (tp + fp) / max(len(ref_final), 1)
        metrics_all.append([recall_, precision_, aa])
    return np.asarray(metrics_all)


def color_map(prob_map, ref_reconstructed, mask_no_considered, clipping_mask, th):
    """utils.py:549-563: threshold the probability map and paint TP=1 / FP=2 /
    FN=3 / past-reference=4 classes (0 elsewhere / outside the clip mask)."""
    reconstructed = (prob_map >= th).astype(np.float32)
    true_positives = reconstructed * ref_reconstructed
    diff_image = reconstructed - ref_reconstructed
    output_map = np.zeros(ref_reconstructed.shape, np.float32)
    output_map[true_positives == 1] = 1
    output_map[diff_image == 1] = 2
    output_map[diff_image == -1] = 3
    output_map[mask_no_considered == 2] = 4
    output_map[clipping_mask == 0] = 0
    return output_map


def rgb_image(class_map):
    """utils.py:264-284 RGB_image: TN white, TP yellow, FP red, FN blue,
    past-reference green."""
    palette = np.array([
        [255, 255, 255], [255, 255, 0], [255, 0, 0], [0, 0, 255], [0, 255, 0],
    ], np.float32)
    return palette[np.asarray(class_map).astype(np.int64)]
