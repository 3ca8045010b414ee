"""The control of the check: the plain reference put in the program's
place, computed one precision step below the configuration's, judged by
the same comparison as a run. ``--lower matmul`` (the default) rounds
the encoder's matmul inputs one step below the configuration's
``encoder_dtype`` (float32 -> TF32, bfloat16 -> float8 e4m3 with one
scale per tensor) and stage B's and the rerank's to TF32, one step below
their fp32; ``--lower dense`` computes the dense scoring alone (the
scan's query, stage A's query sum and the pooled proxies) one step
below the configuration's ``compute_dtype`` (bf16 -> fp8 e4m3). The
readings of the matmul control set the upper end of each limit; the
program's runs set the lower end.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--sample N] [--lower matmul|dense]

Prints one JSON line per seed with the three numbers. Needs no program:
only the generated inputs and the reference (on the card when there is
one).
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def control_numbers(name, seed, device, sample=None, bench=None, cell=None,
                    arch=None, lower="matmul"):
    """-> the numbers of the lowered reference's answers to a sample of
    the cell's queries against the reference's."""
    import numpy as np
    from harness import compare, gen, reference, runner, serve, spec

    bench = spec.load_benchmark() if bench is None else bench
    cell = spec.load_cell(bench, name) if cell is None else cell
    arch = spec.load_config(bench, cell["config"]) if arch is None else arch
    model = spec.load_model(bench, cell["config"])
    reference.exact_fp32()
    size = sample or cell["check"]["sample"]
    inputs = serve.build_inputs(cell, arch, seed, device,
                                runner.WARM_POOL + 4 * size)
    pool = list(range(runner.WARM_POOL, len(inputs.texts)))
    pick = gen.np_rng(seed, "control").choice(len(pool), size=size,
                                               replace=False)
    texts = [inputs.texts[pool[i]] for i in pick]
    terms = [inputs.terms[pool[i]] for i in pick]
    k = cell["queries"]["top_k"]
    ref = runner.make_reference(cell, arch, model, inputs, seed, device)
    q, ids, scores = ref.answers(texts, terms, k)
    if lower == "matmul":
        ctl = runner.make_reference(
            cell, arch, model, inputs, seed, device, "tf32",
            encoder=reference.LOWER_MATMUL[arch["encoder_dtype"]])
    else:
        ctl = runner.make_reference(
            cell, arch, model, inputs, seed, device,
            dense=reference.LOWER_DENSE[arch["compute_dtype"]])
    _, cids, cscores = ctl.answers(texts, terms, k)
    return compare.numbers(cids.numpy(), cscores.numpy().astype(np.float32),
                           ids.numpy(), scores.numpy(),
                           compare.score_fn(ref, q))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sample", type=int, default=None)
    ap.add_argument("--lower", choices=("matmul", "dense"),
                    default="matmul")
    args = ap.parse_args(argv)
    import torch
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        vals = control_numbers(args.workload, seed, dev, args.sample,
                               lower=args.lower)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "lower": args.lower, "control": vals,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
