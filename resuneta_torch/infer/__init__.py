from .sliding import (make_apply_fn, make_seg_ids_fn, predict_patches,
                      predict_scene, predict_scene_overlap, seg_ids_prob1,
                      seg_prob1_f16)

__all__ = ["make_apply_fn", "make_seg_ids_fn", "predict_patches",
           "predict_scene", "predict_scene_overlap", "seg_ids_prob1",
           "seg_prob1_f16"]
