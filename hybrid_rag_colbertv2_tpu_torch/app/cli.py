"""CLI — reference surface (--upload/--chat/--stats/--model,
local_rag_complete.py:1245-1286) plus --query and --bench (SURVEY.md #14).

Port of ``hybrid_rag_colbertv2_tpu/app/cli.py``: the same flags and
outputs, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions). ``--eval`` runs tools/eval_recall.py on the
configured app. ``--bench`` runs the port's bench
(``python -m hybrid_rag_colbertv2_tpu_torch.bench``) on ``--device`` in a
subprocess and returns its exit code; its ``HRAG_BENCH_*`` switches come
through the environment.

Run: ``python -m hybrid_rag_colbertv2_tpu_torch.app.cli --help``
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..config import RAGConfig
from .application import RAGApplication


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hybrid-rag-torch",
        description="Hybrid RAG on PyTorch/CUDA: PDF/markdown ingestion, "
                    "BM25 + ColBERT MaxSim cascade, local-LLM chat",
    )
    p.add_argument("--upload", type=str, action="append",
                   help="upload and index a document (pdf/md/txt); repeatable")
    p.add_argument("--chat", action="store_true",
                   help="start interactive chat")
    p.add_argument("--query", type=str,
                   help="run one retrieval query and print ranked sources")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="start the HTTP JSON API on this port")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address for --serve")
    p.add_argument("--stats", action="store_true",
                   help="show database statistics")
    p.add_argument("--bench", action="store_true",
                   help="run the retrieval benchmark (the port's bench.py; "
                        "passes switched off by HRAG_BENCH_*=0)")
    p.add_argument("--eval", type=int, default=None, metavar="N",
                   help="evaluate retrieval quality over the indexed corpus "
                        "with N pseudo-queries (tools/eval_recall.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")
    p.add_argument("--model", type=str, default=None,
                   help="Ollama chat model (default llama3.2:3b)")
    p.add_argument("--config", type=str, default=None,
                   help="path to a JSON RAGConfig")
    p.add_argument("--db", type=str, default=None, help="SQLite path")
    p.add_argument("--top-k", type=int, default=None,
                   help="results for --query")
    p.add_argument("--final-fusion", type=str, default=None,
                   choices=["rerank", "rrf", "union", "auto"],
                   help="final top-k ordering: 'rerank' = exact MaxSim "
                        "alone (reference parity), 'rrf' = fuse in the "
                        "candidate-RRF ranking, 'union' = rrf plus a "
                        "structural floor guaranteeing both legs' top "
                        "ranks survive into the final top-k (the k-slot "
                        "floor budget splits by the BM25 leg weight), "
                        "'auto' (default) = "
                        "calibrate mode + leg weight by a measured gate "
                        "on held-out pseudo-queries (retrieval/gate.py)")
    p.add_argument("--fusion-weight-bm25", type=float, default=None,
                   metavar="W",
                   help="calibrated-hybrid BM25 leg weight in [0,1]; "
                        "0.5 = the reference's unweighted RRF (set "
                        "explicitly to pin it instead of the auto gate)")
    p.add_argument("--train-encoder", type=int, default=None, metavar="N",
                   help="contrastively train the encoder on the corpus for "
                        "N steps during --upload (self-contained mode)")
    p.add_argument("--convert-index", type=str, default=None,
                   metavar="DTYPE",
                   choices=["int8", "int8-doc", "int4-doc", "bfloat16",
                            "float32"],
                   help="requantize the persisted dense index into "
                        "another layout WITHOUT re-encoding the corpus "
                        "(e.g. int4-doc halves the index's memory); "
                        "drops the measured fusion-gate verdict so "
                        "'auto' re-measures on the new layout")
    p.add_argument("--no-generate", action="store_true",
                   help="retrieval only, skip LLM generation")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    return p


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.bench:
        # the bench builds its own indexes: no app, no database
        import subprocess
        return subprocess.call(
            [sys.executable, "-m", "hybrid_rag_colbertv2_tpu_torch.bench",
             "--device", args.device],
            cwd=Path(__file__).resolve().parents[2])
    cfg = RAGConfig.load(args.config) if args.config else RAGConfig()
    if args.model:
        cfg.chat_model = args.model
    if args.db:
        cfg.db_path = args.db
    if args.train_encoder is not None:
        cfg.encoder_train_steps = args.train_encoder
    if args.final_fusion is not None:
        cfg.final_fusion = args.final_fusion
    if args.fusion_weight_bm25 is not None:
        cfg.fusion_weight_bm25 = args.fusion_weight_bm25
        cfg.fusion_weight_pinned = True   # the auto gate must not override
        cfg.validate()
    app = RAGApplication(cfg, use_ollama=not args.no_generate,
                         device=args.device)

    if args.upload:
        for p in args.upload:
            if not Path(p).exists():
                raise FileNotFoundError(f"document not found: {p}")
        result = app.index_documents(args.upload)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"Indexed {len(result['documents'])} document(s), "
                  f"{result['total_chunks']} chunks total")
            for k, v in result["timings"].items():
                print(f"   * {k}: {v:.2f}s")
        return 0

    if args.convert_index:
        result = app.convert_index(args.convert_index)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"Converted dense index {result['from']} -> "
                  f"{result['to']} ({result['docs']} docs)")
        return 0

    if args.query:
        app.initialize_chatbot()
        results = app.query(args.query, args.top_k)
        if args.json:
            print(json.dumps(results))
        else:
            print(f"Top {len(results)} results for: {args.query!r}")
            for r in results:
                head = f" ({r['heading_path']})" if r.get("heading_path") else ""
                text = (r.get("text", "") or "")[:120].replace("\n", " ")
                print(f"  {r['rank']:2d}. [chunk {r['chunk_id']}"
                      f" score {r['score']:.3f}]{head} {text}")
        return 0

    if args.serve:
        from .server import serve
        app.initialize_chatbot()
        serve(app, host=args.host, port=args.serve)
        return 0

    if args.chat:
        if not args.no_generate and not app.check_ollama():
            print("Warning: Ollama is not reachable at "
                  f"{cfg.ollama_url} — retrieval-only mode.")
            print("To enable generation: run 'ollama serve' and retry.")
        app.initialize_chatbot()
        app.interactive_chat()
        return 0

    if args.stats:
        if args.json:
            print(json.dumps(app.stats()))
        else:
            app.print_stats()
        return 0

    if args.eval:
        # evaluate the ALREADY-configured app (a fresh eval_recall.main
        # would rebuild from defaults and drop --db/--model overrides,
        # silently evaluating the wrong database)
        from ..tools.eval_recall import evaluate
        app.initialize_chatbot(use_mesh=False)
        print(json.dumps(evaluate(app, n_queries=args.eval)))
        return 0

    build_parser().print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
