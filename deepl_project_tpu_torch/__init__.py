"""deepl_project_tpu_torch -- the PyTorch / CUDA port of deepl_project_tpu for
an NVIDIA H100.

This slice carries the bf16 serving path of TransVAE: the model
(``create_transvae``), the batching ``InferenceEngine`` and ``cli.serve``.
The attention sublayers run on hand-written Hopper kernels
(``ops/hopper``, sources in ``csrc/``). Entry points run on CUDA unless the
caller passes ``device="cpu"``, which takes the plain PyTorch path.
"""

from .config import VARIANTS, TransVAEConfig, get_config
from .models import TransVAE, count_params, create_transvae

__version__ = "0.1.0"

__all__ = ["TransVAE", "TransVAEConfig", "VARIANTS", "get_config",
           "create_transvae", "count_params"]
