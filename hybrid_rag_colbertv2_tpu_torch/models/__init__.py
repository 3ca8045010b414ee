from .colbert import (  # noqa: F401
    ColBERTConfig,
    ColBERTEncoder,
    ColBERTModel,
    params_from_jax,
)
from .tokenizer import ColBERTTokenizer, HashTokenizer  # noqa: F401
