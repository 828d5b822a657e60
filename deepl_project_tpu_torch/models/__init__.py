from .decoder import TransVAEDecoder
from .dit import (DIT_VARIANTS, DiT, DiTConfig, create_dit, get_dit_config,
                  init_dit_weights, perturb_zero_init)
from .discriminator import InstanceNorm, PatchDiscriminator, init_disc_weights
from .encoder import TransVAEEncoder
from .transvae import (TransVAE, adaptive_gan_weight, count_params, create_transvae,
                       enable_gradient_checkpointing, from_pretrained, get_last_layer,
                       init_weights, resolve_device)

__all__ = ["TransVAE", "TransVAEEncoder", "TransVAEDecoder", "create_transvae",
           "count_params", "init_weights", "resolve_device", "get_last_layer",
           "adaptive_gan_weight", "PatchDiscriminator", "InstanceNorm",
           "init_disc_weights", "enable_gradient_checkpointing", "from_pretrained",
           "DiT", "DiTConfig", "DIT_VARIANTS", "get_dit_config", "init_dit_weights",
           "create_dit", "perturb_zero_init"]
