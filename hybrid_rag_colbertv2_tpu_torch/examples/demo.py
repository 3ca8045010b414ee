"""End-to-end quickstart: ingest markdown -> dual index -> hybrid retrieval.
Port of the repository's ``examples/demo.py``.

Run:  python -m hybrid_rag_colbertv2_tpu_torch.examples.demo [--device cpu]
      (default the card; no network, no LLM)

Builds a small corpus, indexes it (BM25 CSR + ColBERT token embeddings,
int8), answers queries through the fused cascade, and shows incremental
indexing + persistence. Generation via Ollama is optional and not used
here — retrieval is the on-device path this framework owns.
"""

import argparse
import tempfile
from pathlib import Path

from ..app.application import RAGApplication
from ..config import RAGConfig

DOC_A = """# TPU architecture

## The MXU
TPUs multiply matrices using a systolic array called the MXU. Operands
stream through a grid of multiply-accumulate units every cycle.

## Memory
HBM bandwidth is the usual bottleneck; fusing elementwise work into
matmuls keeps the MXU fed.
"""

DOC_B = """# Retrieval

## Hybrid search
BM25 lexical scores and ColBERT late-interaction scores are fused with
reciprocal rank fusion; the top candidates are exactly rescored.

## Cooking interlude
Boil the pasta in well-salted water until al dente.
"""


def main(device="cuda"):
    """Run the demo on ``device``; -> the incrementally uploaded chunk's
    result row."""
    root = Path(tempfile.mkdtemp(prefix="hrag_demo_"))
    (root / "a.md").write_text(DOC_A)
    (root / "b.md").write_text(DOC_B)

    cfg = RAGConfig(
        db_path=str(root / "rag.db"),
        bm25_index_path=str(root / "indexes/bm25"),
        colbert_index_path=str(root / "indexes/colbert"),
        images_dir=str(root / "images"),
        tokenizer_path=str(root / "indexes/tokenizer.json"),
        min_chunk_size=8, max_chunk_size=128,
        encoder_preset="small", tokenizer_vocab_size=2048,
        dense_prefilter=64,          # pruned two-stage dense search
    )
    app = RAGApplication(cfg, use_ollama=False, device=device)

    print("== indexing two documents ==")
    out = app.index_documents([str(root / "a.md"), str(root / "b.md")])
    print(f"indexed {out['total_chunks']} chunks; timings:",
          {k: round(v, 2) for k, v in out["timings"].items()})

    app.initialize_chatbot()
    for q in ["how does the MXU multiply matrices",
              "what is fused with reciprocal rank fusion",
              "how long to boil pasta"]:
        rows = app.query(q, 2)
        print(f"\nQ: {q}")
        for r in rows:
            print(f"  #{r['rank']} [chunk {r['chunk_id']} "
                  f"score {r['score']:.2f}] {r['text'][:70].strip()!r}")

    print("\n== incremental upload (only the new doc is encoded) ==")
    (root / "c.md").write_text(
        "# Compilers\n\nXLA compiles and fuses ops for TPUs.\n")
    app.index_documents([str(root / "c.md")])
    rows = app.query("XLA compiler fusion", 5)
    hit = next(r for r in rows if "XLA compiles" in r.get("text", ""))
    print(f"  new chunk {hit['chunk_id']} retrievable "
          f"(rank {hit['rank']}/5): {hit['text'][:55].strip()!r}")
    print("  (ranking quality in self-contained mode comes from "
          "--train-encoder or a real checkpoint; see README)")

    print("\ndemo artifacts in", root)
    return hit


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda)")
    main(ap.parse_args().device)
