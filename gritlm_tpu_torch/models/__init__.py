from gritlm_tpu_torch.models.convert import params_from_jax  # noqa: F401
from gritlm_tpu_torch.models.transformer import (  # noqa: F401
    KVCache,
    forward,
    forward_lm,
    init_cache,
    init_params,
)
