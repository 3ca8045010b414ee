"""hybrid_rag_colbertv2_tpu_torch — the PyTorch / CUDA port.

A second package beside ``hybrid_rag_colbertv2_tpu`` (the JAX reference,
left as it is). It serves the same hybrid cascade — BM25 top-k + ColBERT
MaxSim top-k -> weighted RRF -> exact rerank -> final top-k — on an NVIDIA
H100, with the TPU's Pallas kernels rewritten as CUDA C++ kernels for
Hopper (``csrc/``, built at first use by ``ops/_build.py``).

Each module mirrors the JAX module of the same path and name, and reads
and writes the same on-disk formats, so an index built by either package
serves from the other. The package imports torch and numpy, never JAX and
nothing of the JAX package (it keeps its own copies of the JAX-free
modules it needs).

Served so far: the flat index in every layout (int8, int8-doc,
int4-doc, bfloat16, float32), both dense routes (``dense_prefilter`` > 0
pruned, 0 full scan through the layout's CUDA MaxSim kernel), one CUDA
graph replay per query batch (``retrieval/cascade.py::fused_cascade_fn``),
incremental ``add_documents`` and layout ``convert``, fp32 or bf16
encoder activations. See ROADMAP.md for the rest.
"""

__version__ = "0.1.0"

from .config import RAGConfig, MeshConfig  # noqa: F401
