from .cascade import HybridRetriever, hybrid_cascade  # noqa: F401
