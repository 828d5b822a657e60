from .lpips import (get_lpips_params, init_lpips_params, load_lpips_params,
                    lpips, lpips_params_available)
from .teachers import make_stub_teacher, make_vf_teacher
from .vae_loss import (LossWeights, discriminator_loss, gan_generator_loss,
                       kl_divergence, l1_loss, make_self_perceptual, transvae_loss,
                       vf_loss)

__all__ = [
    "LossWeights", "transvae_loss", "l1_loss", "kl_divergence", "vf_loss",
    "gan_generator_loss", "discriminator_loss", "lpips", "get_lpips_params",
    "init_lpips_params", "load_lpips_params", "lpips_params_available",
    "make_self_perceptual", "make_stub_teacher", "make_vf_teacher",
]
