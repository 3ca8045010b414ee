from .maxsim import (  # noqa: F401
    NEG_INF,
    maxsim_scores_exact,
    maxsim_scores_int8,
    maxsim_scores_int8_reference,
)
from .fusion import (  # noqa: F401
    final_topk_select,
    reciprocal_rank_fusion,
    rrf_from_topk,
    union_floor_split,
)
from .bm25 import bm25_scores_device, bm25_topk_device  # noqa: F401
from .prefilter import (  # noqa: F401
    candidate_sims,
    exact_maxsim_on_candidates,
    maxsim_topk_pruned,
    pooled_doc_embeddings,
    pooled_proxy_topk,
)
from .quant import dequantize_int8_rows, quantize_int8_rows  # noqa: F401
from .topk import top_k  # noqa: F401
