"""Contrastive ColBERT training — port of
``hybrid_rag_colbertv2_tpu/train/trainer.py``.

In-batch-negative contrastive training of the encoder (the reference only
downloads a fixed checkpoint). For a batch of (query, positive-doc) pairs
every query is scored against every doc in the batch with true MaxSim,
and softmax cross-entropy is taken against the diagonal. Optional
BM25-mined hard negatives (train/data.py::mine_hard_negatives) extend the
candidate set to positives + negatives. An optional tie regularizer keeps
lexicon synonym embedding rows near their key rows.

What follows the JAX package exactly: the loss (max over doc tokens by
``torch.amax``, which splits the gradient evenly among tied maxima as
JAX's max does), the accuracy (``argmax``, the first index winning a
tie), AdamW with optax's defaults (betas 0.9/0.999, eps 1e-8, the weight
decay on every parameter), the learning rate read from the port's copy
of optax's ``warmup_cosine_decay_schedule`` at the count of updates
BEFORE this one (so the first update uses ``schedule(0) = 0``), the
batch layout and the batch grouping of ``train()``.

What differs: parameters are updated in place (``optimizer.step()``),
which keeps every ``Parameter`` object and its storage, so a CUDA graph
captured over the encoder before training replays with the trained
weights (``retrieval/cascade.py::fused_cascade_fn``); nothing here may
replace a parameter. The JAX package shares compiled steps between
trainers (``_STEP_CACHE``); nothing compiles here, so the port has no
counterpart. Checkpoints are one ``torch.save`` file (the model state,
the optimizer state with its update count, the step), not orbax
directories. Training runs on the encoder's device, in fp32 without
TF32 where the encoder's activations are fp32 (``ColBERTEncoder`` turns
TF32 off, forward and backward).

Under a ``mesh`` (JAX ``train/trainer.py:137-194``) the global batch is
split over the ``data`` axis in contiguous row blocks (JAX's
``P(data, None)``): each data row encodes its block on its own devices,
tensor-parallel over the ``model`` axis when the encoder was given
``parallel/params.py::shard_encoder_params`` for this mesh, else on its
first device; the embeddings are gathered to the mesh's lead in shard
order and the loss is the global batch's, as GSPMD keeps it: every query
against all ``B * (1 + H)`` doc rows of the batch, labels on the global
diagonal. One process drives every shard; autograd sums each shard's
gradient into the one ``Parameter``, and AdamW steps it once.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.colbert import ColBERTEncoder
from ..parallel.mesh import Mesh
from ..parallel.params import TensorParallelPlan
from ..utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    batch_size: int = 16
    doc_len: int = 64
    # softmax temperature over the (B, B) MaxSim score matrix (see the
    # JAX TrainConfig: sharper temperatures leave no ranking signal)
    temperature: float = 1.0
    steps: int = 100
    warmup_steps: int = 10
    seed: int = 0
    # synonym-embedding tie regularizer: tie_weight * mean squared
    # distance between lexicon (key, synonym) embedding rows
    # (train/lexicon.py ``synonym_tie_pairs``)
    tie_weight: float = 0.0
    tie_pairs: Optional[Tuple[Tuple[int, int], ...]] = None


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps``; the values in fp32, as
    optax computes them."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float((f32(init_value) - f32(peak_value)) * frac
                         + f32(peak_value))
        t = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t
                                             / f32(cos_steps)))
        return float(f32(peak_value) * ((f32(1) - f32(alpha)) * cosine
                                        + f32(alpha)))

    return schedule


def _maxsim_matrix(q_emb: torch.Tensor, d_emb: torch.Tensor,
                   d_mask: torch.Tensor) -> torch.Tensor:
    """All-pairs MaxSim: (B,Lq,D) x (C,Ld,D) -> (B,C) scores, in fp32."""
    sims = torch.einsum("bqd,cld->bcql", q_emb.float(), d_emb.float())
    sims = torch.where(d_mask[None, :, None, :].bool(), sims,
                       torch.tensor(-1e30, dtype=sims.dtype,
                                    device=sims.device))
    return torch.amax(sims, dim=-1).sum(dim=-1)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], temperature: float,
                    tie_weight: float = 0.0,
                    tie_pairs: Optional[Tuple[Tuple[int, int], ...]] = None,
                    plan: Optional[TensorParallelPlan] = None):
    """-> step(batch, count) -> {"loss", "accuracy"} (0-d tensors): one
    AdamW update of ``model``'s parameters in place, at the learning rate
    ``schedule(count)``, ``count`` being the updates made before it.

    batch: dict of q_ids/q_mask/d_ids/d_mask tensors on the model's
    device, doc rows positives first. With ``plan`` its rows are split
    over the plan's data axis (``TensorParallelPlan.encode_rows``)."""
    params = list(model.parameters())
    use_tie = tie_weight > 0.0 and tie_pairs
    if use_tie:
        dev = params[0].device
        tie_a = torch.tensor([p[0] for p in tie_pairs], dtype=torch.long,
                             device=dev)
        tie_b = torch.tensor([p[1] for p in tie_pairs], dtype=torch.long,
                             device=dev)

    def step(batch: Dict[str, torch.Tensor], count: int
             ) -> Dict[str, torch.Tensor]:
        if plan is None:
            q_emb = model(batch["q_ids"], batch["q_mask"])
            d_emb = model(batch["d_ids"], batch["d_mask"])
        else:
            q_emb = plan.encode_rows(model, batch["q_ids"], batch["q_mask"])
            d_emb = plan.encode_rows(model, batch["d_ids"], batch["d_mask"])
        scores = _maxsim_matrix(q_emb, d_emb, batch["d_mask"]) / temperature
        labels = torch.arange(scores.shape[0], device=scores.device)
        loss = F.cross_entropy(scores, labels)
        acc = (torch.argmax(scores, dim=-1) == labels).float().mean()
        if use_tie:
            table = model.word_embeddings.weight
            diff = table[tie_a] - table[tie_b]
            loss = loss + tie_weight * torch.mean(
                torch.sum(diff * diff, dim=-1))
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for p in params:
            # optax updates every leaf; torch skips a parameter with no
            # gradient, so give it zeros (decay and moments still apply)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in optimizer.param_groups:
            group["lr"] = schedule(count)
        optimizer.step()
        return {"loss": loss.detach(), "accuracy": acc.detach()}

    return step


class ColBERTTrainer:
    """Host-side loop: tokenize pairs, batch, step on the encoder's
    device, or over ``mesh`` (the batch sharded on ``data_axis``)."""

    def __init__(self, encoder: ColBERTEncoder,
                 train_cfg: Optional[TrainConfig] = None,
                 mesh: Optional[Mesh] = None, data_axis: str = "data"):
        self.encoder = encoder
        self.cfg = train_cfg or TrainConfig()
        self.device = encoder.device
        self.mesh = mesh
        self.data_axis = data_axis
        self.plan = None
        if mesh is not None:
            self.plan = encoder.model.tp_plan
            if self.plan is None:
                # replicated parameters: data parallelism alone
                self.plan = TensorParallelPlan(mesh, tensor_parallel=False,
                                               data_axis=data_axis)
            elif self.plan.mesh != mesh:
                raise ValueError("the encoder is sharded over another mesh "
                                 "than the trainer's")
        cfg = self.cfg
        self.schedule = warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.steps, cfg.warmup_steps + 1))
        self.optimizer = torch.optim.AdamW(
            encoder.model.parameters(), lr=0.0, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=cfg.weight_decay)
        self.updates = 0        # the schedule's count (optax's step count)
        self.step_fn = make_train_step(encoder.model, self.optimizer,
                                       self.schedule, cfg.temperature,
                                       cfg.tie_weight, cfg.tie_pairs,
                                       self.plan)

    # ------------------------------------------------------------------
    def _make_batch(self, pairs: Sequence[Sequence]) -> Dict[str,
                                                             torch.Tensor]:
        """pairs: (query_text, positive_doc_text) or
        (query_text, positive_doc_text, [hard_negative_texts...]).

        Doc rows are laid out positives-first — rows 0..B-1 are the
        positives so the (B, C) score matrix's diagonal is the label —
        followed by every pair's hard negatives. All rows in one batch
        must carry the same negative count."""
        cfg = self.encoder.cfg
        q_ids = np.stack([
            self.encoder.tokenizer.encode_query(p[0], cfg.query_max_tokens)
            for p in pairs])
        q_mask = np.ones_like(q_ids)
        doc_texts = [p[1] for p in pairs]
        n_neg = len(pairs[0][2]) if len(pairs[0]) > 2 else 0
        for p in pairs:
            got = len(p[2]) if len(p) > 2 else 0
            if got != n_neg:
                raise ValueError(
                    f"inconsistent hard-negative counts in batch: "
                    f"{got} != {n_neg}")
        if n_neg:
            for p in pairs:
                doc_texts.extend(p[2])
        d_ids, d_ns = self.encoder.tokenizer.encode_docs(
            doc_texts, self.cfg.doc_len)
        d_mask = (np.arange(self.cfg.doc_len)[None, :]
                  < d_ns[:, None]).astype(np.int32)
        batch = {"q_ids": q_ids, "q_mask": q_mask,
                 "d_ids": d_ids, "d_mask": d_mask}
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, path: str, step: int = 0) -> None:
        """Persist params + optimizer state (with the schedule's update
        count) + step for resume, as one ``torch.save`` file."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"params": self.encoder.model.state_dict(),
                    "opt_state": {"optimizer": self.optimizer.state_dict(),
                                  "count": self.updates},
                    "step": step}, p)

    def restore_checkpoint(self, path: str) -> int:
        """Load a ``save_checkpoint`` file in place (every parameter keeps
        its object and storage); -> the saved step."""
        state = torch.load(Path(path), map_location=self.device,
                           weights_only=True)
        self.encoder.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"]["optimizer"])
        self.updates = int(state["opt_state"]["count"])
        return int(state["step"])

    # ------------------------------------------------------------------
    def train(self, pairs: List[Sequence], steps: Optional[int] = None
              ) -> List[Dict]:
        """Cycle through (query, doc-text[, neg-texts]) tuples; returns
        per-step metrics. With 3-tuples each batch scores queries against
        positives + every pair's BM25-mined hard negatives."""
        steps = steps or self.cfg.steps
        bs = self.cfg.batch_size
        if len(pairs) < bs:
            reps = -(-bs // max(len(pairs), 1))
            pairs = (pairs * reps)[: max(bs, len(pairs))]
        # pre-group into batches with DISTINCT positive docs — duplicated
        # positives make in-batch-negative labels ambiguous
        batches: List[List] = []
        cur: List = []
        seen: set = set()
        leftovers: List = []
        for p in pairs:
            if p[1] in seen:
                leftovers.append(p)
            else:
                cur.append(p)
                seen.add(p[1])
            if len(cur) == bs:
                batches.append(cur)
                cur, seen = [], set()
        for p in leftovers:          # fill remaining slots, allowing dups
            if p[1] in seen:
                continue
            cur.append(p)
            seen.add(p[1])
            if len(cur) == bs:
                batches.append(cur)
                cur, seen = [], set()
        if cur and not batches:
            # fewer distinct positives than batch_size: train on the
            # smaller batch rather than tiling pairs (duplicated positives
            # would compete as negatives). Under a mesh the batch axis
            # must divide the data axis; trim to the largest multiple.
            if self.mesh is not None:
                n_data = self.mesh.shape[self.data_axis]
                keep = (len(cur) // n_data) * n_data
                if keep == 0:
                    log.warning(
                        "only %d distinct training pairs for a %d-way "
                        "data mesh — skipping training", len(cur), n_data)
                cur = cur[:keep]
            if cur:
                batches.append(cur)
        if not batches:
            log.warning("no trainable batches — returning without training")
            return []
        metrics: List[Dict] = []
        bpos = 0
        # tokenize each batch ONCE on first use and reuse the device
        # tensors across epochs (the pair->batch grouping is fixed)
        batch_cache: List[Optional[Dict]] = [None] * len(batches)
        try:
            for step in range(steps):
                if bpos >= len(batches):
                    bpos = 0
                if batch_cache[bpos] is None:
                    batch_cache[bpos] = self._make_batch(batches[bpos])
                batch = batch_cache[bpos]
                bpos += 1
                m = self.step_fn(batch, self.updates)
                self.updates += 1
                metrics.append({k: float(v) for k, v in m.items()})
                if step % 20 == 0 or step == steps - 1:
                    log.info("train step %d: loss=%.4f acc=%.3f", step,
                             metrics[-1]["loss"], metrics[-1]["accuracy"])
        finally:
            self.optimizer.zero_grad(set_to_none=True)   # free the grads
        return metrics
