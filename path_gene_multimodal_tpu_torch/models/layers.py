"""Shared transformer building blocks, as ``nn.Module``s.

Counterpart of the JAX package's ``models/layers.py`` (flax). Parameters
stay f32, as flax keeps them; each module computes in its ``dtype`` and
rounds where flax rounds (the points ``tests/test_torch_clip.py`` holds):

- a dense or conv product casts its input and kernel to ``dtype``,
  accumulates in f32 and returns ``dtype``; its bias is cast and added in
  ``dtype`` after the product (two roundings, as ``nn.Dense``);
- a LayerNorm takes its statistics in f32 and rounds its output to
  ``dtype`` once, with f32 scale and bias (``nn.LayerNorm(dtype=...)``);
- attention scales **q** by ``hd ** -0.5`` in ``dtype`` (the scale itself
  rounded to ``dtype``, as a weak-typed JAX scalar is) *before* QK^T,
  takes the logits in f32, and rounds the softmax to ``dtype`` before PV
  (``layers.py:47-54``). Scaling the logits instead, or keeping the
  probabilities in f32, would be a different rounding;
- ``quick_gelu`` and the tanh GELU run in ``dtype`` op by op, their
  constants rounded to ``dtype``, as XLA computes them.

State-dict names are OpenAI CLIP's (``ln_1``, ``attn.in_proj_weight`` /
``in_proj_bias``, ``attn.out_proj``, ``ln_2``, ``mlp.c_fc``,
``mlp.c_proj``), the names the JAX package's ``convert_clip_vision``
reads. The attention is written out, not ``scaled_dot_product_attention``,
which folds the scale and the softmax precision otherwise.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x), in x's dtype. The sigmoid is
    written as XLA expands ``lax.logistic``, 1 / (1 + exp(-z)), each step
    rounded to the dtype (``torch.sigmoid`` rounds once)."""
    z = x * _rounded(1.702, x.dtype)
    return x * torch.reciprocal(1 + torch.exp(-z))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (``jax.nn.gelu``, tanh approximation) step by
    step in x's dtype: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x³)))."""
    c = _rounded(float(np.sqrt(2 / np.pi)), x.dtype)
    inner = c * (x + _rounded(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _rounded(v: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``, as JAX casts a weak-typed
    scalar before an elementwise op (torch would keep it in f32)."""
    return torch.tensor(v, dtype=dtype).item()


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)`` with a torch (out, in) weight: the product
    in ``dtype`` with f32 accumulation, then the bias added in ``dtype``."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    return y if bias is None else y + bias.to(dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``nn.LayerNorm(dtype=dtype)``: statistics in f32, f32 scale and bias,
    the output rounded to ``dtype`` once. The input is upcast first: on the
    card ``F.layer_norm`` takes input and scale in one dtype."""
    x = x.to(ln.weight.dtype)
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (.., n, hd) @ k^T in f32 from ``dtype`` operands. A bf16 value is
    exact in f32 (and in TF32), so the f32 product of the upcast operands is
    the ``preferred_element_type=float32`` product of the bf16 ones."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


@contextlib.contextmanager
def product_precision(dtype: torch.dtype):
    """cuBLAS/cuDNN flags under which every product of a module computing
    in ``dtype`` accumulates in f32 as flax's do, whatever the caller's
    global flags (restored after): in f32 no TF32; in bf16 no reduced-
    precision split-K sums, and TF32 for the f32 logits, whose operands are
    bf16 values and so exact in TF32."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = cudnn.allow_tf32 = dtype != torch.float32
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with one fused QKV product (OpenAI's
    ``in_proj_weight`` rows: q, k, v)."""

    def __init__(self, width: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        q, k, v = qkv.view(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)  # (b, h, n, hd) each
        logits = _logits(q * _rounded(hd ** -0.5, q.dtype), k)
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.matmul(probs, v)  # dtype, f32 accumulation
        out = out.transpose(1, 2).reshape(b, n, d)
        return dense(out, self.out_proj.weight, self.out_proj.bias, self.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)); x + mlp(ln_2(x))."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 act: Callable = quick_gelu, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.dtype = dtype
        hidden = int(width * mlp_ratio)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiHeadAttention(width, num_heads, dtype)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, hidden),
                                  "c_proj": nn.Linear(hidden, width)})

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x + self.attn(layer_norm(self.ln_1, x, dt), mask)
        fc, proj = self.mlp["c_fc"], self.mlp["c_proj"]
        y = self.act(dense(layer_norm(self.ln_2, x, dt), fc.weight, fc.bias, dt))
        return x + dense(y, proj.weight, proj.bias, dt)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, num_heads: int, mlp_ratio: float = 4.0,
                 act: Callable = quick_gelu, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            TransformerBlock(width, num_heads, mlp_ratio, act, dtype) for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, mask)
        return x
