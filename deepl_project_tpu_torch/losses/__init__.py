from .lpips import (get_lpips_params, init_lpips_params, load_lpips_params,
                    lpips, lpips_params_available)
from .vae_loss import (LossWeights, discriminator_loss, gan_generator_loss,
                       kl_divergence, l1_loss, transvae_loss, vf_loss)

__all__ = [
    "LossWeights", "transvae_loss", "l1_loss", "kl_divergence", "vf_loss",
    "gan_generator_loss", "discriminator_loss", "lpips", "get_lpips_params",
    "init_lpips_params", "load_lpips_params", "lpips_params_available",
]
