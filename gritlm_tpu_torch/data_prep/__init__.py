"""Training-data preparation of the port (gritlm_tpu.data_prep's
counterpart): the format contract's validation, reformatting and hygiene
checks, and hard-negative mining over the port's FlatIndex."""

from gritlm_tpu_torch.data_prep.format import (  # noqa: F401
    validate_embedding_row,
    validate_generative_row,
    validate_file,
    reformat_pairs,
    reformat_chat,
    dataset_length_stats,
    check_decontamination,
)
from gritlm_tpu_torch.data_prep.mine_negatives import mine_hard_negatives  # noqa: F401
