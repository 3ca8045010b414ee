from .maxsim import (  # noqa: F401
    NEG_INF,
    maxsim_scores,
    maxsim_scores_exact,
    maxsim_scores_int4_doc,
    maxsim_scores_int8,
    maxsim_scores_int8_doc,
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
from .quant import (  # noqa: F401
    dequantize_int4_groups,
    dequantize_int8_rows,
    int4_group_size,
    quantize_int4_groups,
    quantize_int8_docs,
    quantize_int8_rows,
    unpack_int4,
    unpack_int4_pairs,
)
from .topk import top_k  # noqa: F401
