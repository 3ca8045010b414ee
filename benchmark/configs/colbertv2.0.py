"""The plain reference of ``colbertv2.0`` (beside its file of sizes):
BERT-base, post-LayerNorm blocks with exact GELU, learned positions
from the file's ``learned_position_start``, token type row 0, the
768 -> 128 ColBERT head and the L2 norm; fp32, every query position
attended. The weights it reads are named by ``param_specs``."""

from harness.encoders import encode_queries, param_specs  # noqa: F401
