from .datasets import make_dataset, synthetic_dataset, synthetic_shapes_dataset
from .pipeline import batch_iterator, input_pipeline, prefetch_to_device

__all__ = ["make_dataset", "synthetic_dataset", "synthetic_shapes_dataset",
           "batch_iterator", "input_pipeline", "prefetch_to_device"]
