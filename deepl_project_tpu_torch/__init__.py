"""deepl_project_tpu_torch -- the PyTorch / CUDA port of deepl_project_tpu for
an NVIDIA H100.

It carries the serving path of TransVAE in bf16 or int8 (the model,
``create_transvae``, ``from_pretrained``, ``quantize.quantize_model``, the
batching ``InferenceEngine`` and ``cli.serve``), evaluation (PSNR, SSIM,
LPIPS, InceptionV3 rFID, latent diagnostics and the linear probe), both
training stages (``training.Trainer``, ``cli.train``: L1 + LPIPS (VGG or
the self-perceptual net) + KL + VF alignment to a teacher, AdamW or
Adafactor, gradient checkpointing, checkpoints, TensorBoard scalars; stage
2 adds the PatchGAN discriminator and its GAN step), the data sources
(synthetic, image folders, COCO and Hugging Face streaming, decoded by the
native C++ decoder or PIL), and the latent DiT of the paper's Table 2(b)
(``models.DiT``, the single-device Switch MoE FFN, rectified-flow training
and the CFG sampler in ``training.diffusion``, ``cli.train_dit`` and
``cli.sample_dit``), whose tokenizer encodes and decodes through the same
kernels. The attention sublayers and the flash attention
forward and backward run on hand-written Hopper kernels (``ops/hopper``,
sources in ``csrc/``). Entry points run on CUDA unless the caller passes
``device="cpu"``, which takes the plain PyTorch path.
"""

from .config import VARIANTS, TransVAEConfig, get_config
from .models import TransVAE, count_params, create_transvae, from_pretrained

__version__ = "0.1.0"

__all__ = ["TransVAE", "TransVAEConfig", "VARIANTS", "get_config",
           "create_transvae", "count_params", "from_pretrained"]
