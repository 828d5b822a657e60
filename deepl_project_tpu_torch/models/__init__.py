from .decoder import TransVAEDecoder
from .encoder import TransVAEEncoder
from .transvae import (TransVAE, count_params, create_transvae, init_weights,
                       resolve_device)

__all__ = ["TransVAE", "TransVAEEncoder", "TransVAEDecoder", "create_transvae",
           "count_params", "init_weights", "resolve_device"]
