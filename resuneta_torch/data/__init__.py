from .isprs import LABEL_DICT, binarize_matrix, class_ids_to_rgb, load_npy_image

__all__ = ["LABEL_DICT", "binarize_matrix", "class_ids_to_rgb",
           "load_npy_image"]
