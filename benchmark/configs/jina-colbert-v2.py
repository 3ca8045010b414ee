"""The plain reference of ``jina-colbert-v2`` (beside its file of
sizes): XLM-RoBERTa, post-LayerNorm blocks with exact GELU, rotary
positions (base 10000, the two halves of each head rotated), no token
types, the 1024 -> 128 ColBERT head and the L2 norm; fp32, every query
position attended. The weights it reads are named by ``param_specs``."""

from harness.encoders import encode_queries, param_specs  # noqa: F401
