from .datasets import (coco_dataset, hf_streaming_dataset, image_folder_dataset,
                       make_dataset, synthetic_dataset, synthetic_shapes_dataset)
from .pipeline import batch_iterator, input_pipeline, prefetch_to_device, row_filter
from .transforms import preprocess_file, preprocess_image

__all__ = ["make_dataset", "synthetic_dataset", "synthetic_shapes_dataset",
           "image_folder_dataset", "coco_dataset", "hf_streaming_dataset",
           "batch_iterator", "input_pipeline", "prefetch_to_device", "row_filter",
           "preprocess_file", "preprocess_image"]
