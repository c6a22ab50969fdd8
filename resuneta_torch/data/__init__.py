from .dataset import (ArrayDataset, DirectoryPairDataset, LegacyPatchDataset,
                      PackedDataset, write_packed_dataset)
from .isprs import LABEL_DICT, binarize_matrix, class_ids_to_rgb, load_npy_image
from .pipeline import make_device_pipeline, make_label_head_pipeline

__all__ = ["ArrayDataset", "DirectoryPairDataset", "LABEL_DICT",
           "LegacyPatchDataset", "PackedDataset", "binarize_matrix",
           "class_ids_to_rgb", "load_npy_image", "make_device_pipeline",
           "make_label_head_pipeline", "write_packed_dataset"]
