from gritlm_tpu_torch.rag.engine import RAGEngine, CacheMode  # noqa: F401
from gritlm_tpu_torch.rag.metrics import exact_match_score, f1_score, match_score  # noqa: F401
from gritlm_tpu_torch.rag.tasks import get_task, register_task, filter_results_by_id  # noqa: F401
from gritlm_tpu_torch.rag.corpus import load_passages, synthetic_passages, passage_text  # noqa: F401
