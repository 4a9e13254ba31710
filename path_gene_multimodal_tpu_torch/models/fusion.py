"""Multimodal fusion: slide-level histology embeddings × gene expression.

A copy of the JAX package's ``models/fusion.py``, the reference repo's
namesake capability (BASELINE.json configs[4]: "Multimodal fusion:
slide-level embeddings + gene-expression vectors"; the tile features the
embed stage writes are its per-slide histology side):

- ``AttentionPool``: gated attention MIL pooling (Ilse et al.) of (N, D)
  tile embeddings, or of a batch of bags (B, N, D) padded under a mask;
- ``slide_embedding``: mean / max / mean_max aggregation (numpy);
- ``GeneExpressionTable``: genes × samples CSV/TSV loader and normalizer
  (log1p + per-gene z-score; numpy and pandas, byte-equal to JAX's);
- ``FusionHead``: per-modality projection → concat → MLP → task logits;
- ``make_fusion_trainer``: (state, step, predict) with a functional
  full-batch step (softmax cross-entropy, ``optax.adamw``'s update,
  ``parallel.train.adamw_update``).

The Dense layers are flax's ``nn.Dense`` (``models.layers.dense``: the
product, then the bias); the GELUs flax's tanh approximation. The
parameters are the port's own (``nn.Linear`` names ``proj_hist``,
``proj_gene``, ``fc1``, ``fc2``; ``attn_v``, ``attn_u``, ``attn_w``);
``models.weights_fusion`` turns flax's into them. Seeded initial weights
follow flax's initializers (truncated LeCun normal kernels, zero biases)
drawn from a ``torch.Generator``, not JAX's PRNG; dropout draws its masks
on the host from a ``torch.Generator`` whose state travels in the training
state, so that a run on the card and its replay on the CPU draw the same
masks, and a restored state resumes bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from path_gene_multimodal_tpu_torch.models.layers import dense
from path_gene_multimodal_tpu_torch.ops.cuda import exact_f32
from path_gene_multimodal_tpu_torch.parallel.train import SplitStep, adamw_init, value_and_grad

# ---------------------------------------------------------------------------
# slide-level aggregation
# ---------------------------------------------------------------------------


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.Dense`` in f32: the product, then the bias."""
    return dense(x, layer.weight, layer.bias, torch.float32)


class AttentionPool(nn.Module):
    """Gated attention MIL pooling (Ilse et al.) over tile embeddings.
    ``forward(tiles (..., N, D), mask (..., N) | None) → (..., D)``."""

    def __init__(self, dim: int, hidden: int = 128):
        super().__init__()
        self.attn_v = nn.Linear(dim, hidden)
        self.attn_u = nn.Linear(dim, hidden)
        self.attn_w = nn.Linear(hidden, 1)

    def forward(self, tiles: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        a = torch.tanh(_dense(self.attn_v, tiles))
        g = torch.sigmoid(_dense(self.attn_u, tiles))
        scores = _dense(self.attn_w, a * g)[..., 0]
        if mask is not None:
            mask = mask.bool()
            anyv = mask.any(-1, keepdim=True)
            # an all-padding bag gives a zero embedding, as in JAX; its
            # scores are zeroed first so that its softmax (and gradient)
            # stays finite where JAX's is NaN under the select
            scores = torch.where(mask, scores, float("-inf"))
            scores = torch.where(anyv, scores, 0.0)
        weights = torch.softmax(scores, dim=-1)
        if mask is not None:
            weights = torch.where(anyv, weights, 0.0)
        return (weights.unsqueeze(-1) * tiles).sum(-2)


def slide_embedding(
    tile_features: np.ndarray, method: str = "mean"
) -> np.ndarray:
    """(N, D) tile features → (D,) slide vector. ``method``: "mean" |
    "max" | "mean_max" (concat)."""
    f = np.asarray(tile_features, np.float32)
    if len(f) == 0:
        raise ValueError("no tile features to aggregate")
    if method == "mean":
        return f.mean(axis=0)
    if method == "max":
        return f.max(axis=0)
    if method == "mean_max":
        return np.concatenate([f.mean(axis=0), f.max(axis=0)])
    raise ValueError(f"unknown aggregation {method!r}")


# ---------------------------------------------------------------------------
# gene expression
# ---------------------------------------------------------------------------


@dataclass
class GeneExpressionTable:
    """genes × samples matrix with normalization."""

    samples: list[str]
    genes: list[str]
    values: np.ndarray  # (num_samples, num_genes) float32, normalized

    @classmethod
    def from_csv(
        cls,
        path: str | Path,
        log1p: bool = True,
        zscore: bool = True,
        sep: str | None = None,
    ) -> "GeneExpressionTable":
        """CSV/TSV with genes as rows and samples as columns (typical TCGA
        export layout; first column = gene id)."""
        path = Path(path)
        if sep is None:
            sep = "\t" if path.suffix.lower() in {".tsv", ".txt"} else ","
        df = pd.read_csv(path, sep=sep, index_col=0)
        genes = [str(g) for g in df.index]
        samples = [str(c) for c in df.columns]
        mat = df.to_numpy(np.float32).T  # (samples, genes)
        if log1p:
            mat = np.log1p(np.maximum(mat, 0.0))
        if zscore:
            mu = mat.mean(axis=0, keepdims=True)
            sd = mat.std(axis=0, keepdims=True)
            mat = (mat - mu) / np.maximum(sd, 1e-8)
        return cls(samples=samples, genes=genes, values=mat)

    def vector_for(self, sample: str) -> np.ndarray:
        try:
            return self.values[self.samples.index(sample)]
        except ValueError:
            raise KeyError(f"sample {sample!r} not in expression table") from None


# ---------------------------------------------------------------------------
# fusion head
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


class FusionHead(nn.Module):
    """Histology + expression → task logits. ``forward(slide_emb (B,
    hist_dim), gene_expr (B, gene_dim), train=False, generator=None,
    keep=None)``; with ``train`` the dropout after fc1 takes its keep mask
    (B, hidden) bool from ``keep``, else draws it from ``generator`` (a host
    ``torch.Generator``)."""

    def __init__(self, hist_dim: int, gene_dim: int, num_outputs: int = 2, proj_dim: int = 256,
                 hidden: int = 256, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.proj_hist = nn.Linear(hist_dim, proj_dim)
        self.proj_gene = nn.Linear(gene_dim, proj_dim)
        self.fc1 = nn.Linear(2 * proj_dim, hidden)
        self.fc2 = nn.Linear(hidden, num_outputs)

    def forward(self, slide_emb: torch.Tensor, gene_expr: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        h = _dense(self.proj_hist, slide_emb)
        g = _dense(self.proj_gene, gene_expr)
        x = torch.cat([_gelu(h), _gelu(g)], dim=-1)
        x = _gelu(_dense(self.fc1, x))
        if train and self.dropout > 0:
            keep_prob = 1.0 - self.dropout
            if keep is None:
                keep = torch.rand(x.shape, generator=generator) < keep_prob
            x = torch.where(keep.to(x.device), x / keep_prob, 0.0)
        return _dense(self.fc2, x)


def flax_init(module: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Seeded weights by flax's Dense initializers: kernels from the
    truncated normal of variance 1/fan_in (``lecun_normal``: std
    sqrt(1/fan_in) / .8796 cut at ±2 std), biases zero; drawn on the host
    from ``generator`` in ``state_dict`` order."""
    out = {}
    for k, p in module.state_dict().items():
        if k.endswith("bias"):
            out[k] = torch.zeros(p.shape)
        else:
            std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
            w = torch.empty(p.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            out[k] = w
    return out


def make_fusion_trainer(
    model: FusionHead,
    hist_dim: int,
    gene_dim: int,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """→ (state, step, predict). ``step(state, hist, genes, labels)`` is one
    full-batch AdamW step returning (new state, loss) and leaving ``state``
    as it was; ``predict(state, hist, genes)`` the class probabilities. The
    state holds ``params`` (the model's ``state_dict`` names; other
    weights of those shapes may replace them before the first step),
    ``opt`` and ``rng`` (the dropout generator's state). The initial
    weights are ``flax_init``'s from ``torch.Generator`` of ``seed``, whose
    state after those draws seeds the dropout. Runs on ``device`` (the card
    unless the caller passes ``"cpu"``), without TF32. ``step`` is a
    ``parallel.train.SplitStep``: its ``draw`` takes the dropout's keep mask
    for the global batch, (rows, hidden), on the host, so that a shard of
    ``shard_step_over_mesh`` trains on the single-device run's masks."""
    if (model.proj_hist.in_features, model.proj_gene.in_features) != (hist_dim, gene_dim):
        raise ValueError(f"FusionHead takes ({model.proj_hist.in_features}, "
                         f"{model.proj_gene.in_features}) inputs, not ({hist_dim}, {gene_dim})")
    dev = torch.device(device)
    model = model.to(dev)
    gen = torch.Generator().manual_seed(seed)
    params = {k: v.to(dev) for k, v in flax_init(model, gen).items()}
    state = {"params": params, "opt": adamw_init(params), "rng": gen.get_state()}

    keep_prob = 1.0 - model.dropout

    def draw(state, n):
        if model.dropout <= 0:
            return None, state["rng"]
        g = torch.Generator()
        g.set_state(state["rng"])
        keep = torch.rand((n, model.fc1.out_features), generator=g) < keep_prob
        return keep, g.get_state()

    def loss_grad(params, keep, hist, genes, labels, n):
        def loss_of(p):
            logits = functional_call(model, p, (hist, genes), {"train": True, "keep": keep})
            return F.cross_entropy(logits, labels.long(), reduction="sum") / n

        return value_and_grad(loss_of, params)

    step = SplitStep(draw, loss_grad, learning_rate, dev)

    @torch.no_grad()
    def predict(state, hist, genes):
        hist, genes = (torch.as_tensor(a, device=dev) for a in (hist, genes))
        with exact_f32():
            return torch.softmax(functional_call(model, state["params"], (hist, genes)), dim=-1)

    return state, step, predict

