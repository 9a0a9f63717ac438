from gritlm_tpu_torch.ops.attention import multi_head_attention  # noqa: F401
from gritlm_tpu_torch.ops.pooling import pool  # noqa: F401
