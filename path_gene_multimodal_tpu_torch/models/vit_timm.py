"""timm-style Vision Transformer: the Virchow2 tile tower.

Counterpart of the JAX package's ``models/vit_timm.py``. The reference's
``MODEL_TYPE="Virchow2"`` (``extract_embedding_from_tiles.py:14``) loads
``paige-ai/Virchow2``, a timm ``VisionTransformer``: ViT-H/14 with 4
register tokens, packed SwiGLU MLPs (gate first, SiLU) at ratio 5.3375,
LayerScale, fused-qkv attention, no pre-LN, and the tile embedding
concat(cls token, mean of the patch tokens) after the final norm, 2560-d.

``TimmViT``'s ``state_dict()`` has timm's names: ``cls_token`` (1, 1, D),
``reg_token`` (1, R, D), ``pos_embed`` (1, P, D), ``patch_embed.proj``,
``blocks.N.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1,
mlp.fc2, ls2.gamma}`` and ``norm``, so a published checkpoint loads with
``load_state_dict(strict=True)`` and the JAX package's ``convert_timm_vit``
consumes it whole.

Parameters stay f32; ``dtype`` is the compute dtype, rounded where flax
rounds (``models/layers.py``): products in ``dtype`` with f32 accumulation
and the bias added in ``dtype``; LayerNorm (eps 1e-6) with f32 statistics,
rounded once; q scaled by ``hd ** -0.5`` in ``dtype`` before QK^T, the
logits and the softmax in f32, the probabilities rounded to ``dtype``
before PV; SiLU as ``x / (1 + exp(-x))`` step by step in ``dtype`` (XLA's
``logistic``), exact GELU as ``0.5 x erfc(-x sqrt(1/2))``; the LayerScale
gamma cast to the activations' dtype; under ``"patches_only"`` the
position embedding is added before the cls and register tokens are
prepended; the pooled mean sums in f32. The attention is written out (a
fused attention would round elsewhere).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from path_gene_multimodal_tpu_torch.models.layers import (
    _logits,
    _rounded,
    dense,
    layer_norm,
    product_precision,
)

# head counts for standard ViT widths (not derivable from weight shapes)
_HEADS_BY_WIDTH = {384: 6, 768: 12, 1024: 16, 1280: 16, 1408: 16, 1536: 24}


@dataclass(frozen=True)
class TimmViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    num_registers: int = 4
    mlp_hidden: int = 6832      # fc1 output features (SwiGLU: 2x the gate width)
    mlp_type: str = "swiglu"    # "swiglu" (GluMlp gate-first SiLU) | "gelu"
    use_layerscale: bool = True
    # "prefix": pos_embed covers cls+reg+patches (timm no_embed_class=False)
    # "patches_only": pos_embed covers patches; prefix tokens unposed
    pos_embed_mode: str = "patches_only"
    pool: str = "cls+mean"      # Virchow2 embedding = concat(cls, patch mean)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return 1 + self.num_registers + self.grid * self.grid

    @property
    def pos_len(self) -> int:
        return self.grid * self.grid if self.pos_embed_mode == "patches_only" else self.seq_len

    @property
    def out_width(self) -> int:
        return 2 * self.width if self.pool == "cls+mean" else self.width


# paige-ai/Virchow2: ViT-H/14, 4 registers, SwiGLU ratio 5.3375,
# LayerScale, embedding 2560 = concat(cls, patch-mean)
VIRCHOW2_TIMM = TimmViTConfig()


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` in x's dtype: x * 1 / (1 + exp(-x)), each step
    rounded to the dtype as XLA expands ``lax.logistic``."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=False)`` in x's dtype:
    0.5 x erfc(-x sqrt(1/2))."""
    return (0.5 * x) * torch.erfc(-x * _rounded(float(np.sqrt(0.5)), x.dtype))


class TimmAttention(nn.Module):
    """timm ``Attention``: fused qkv Linear (rows q, k, v, each head-major),
    per-head softmax, output projection."""

    def __init__(self, width: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = dense(x, self.qkv.weight, self.qkv.bias, self.dtype)
        q, k, v = qkv.view(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)  # (b, h, n, hd) each
        logits = _logits(q * _rounded(hd ** -0.5, q.dtype), k)
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d)
        return dense(out, self.proj.weight, self.proj.bias, self.dtype)


class Mlp(nn.Module):
    """``mlp.fc1`` / ``mlp.fc2``: timm's packed SwiGLU (``GluMlp``,
    gate first: silu(first half) * second half) or a GELU MLP."""

    def __init__(self, width: int, hidden: int, swiglu: bool, dtype: torch.dtype):
        super().__init__()
        self.swiglu = swiglu
        self.dtype = dtype
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden // 2 if swiglu else hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dense(x, self.fc1.weight, self.fc1.bias, self.dtype)
        if self.swiglu:
            gate, val = y.chunk(2, dim=-1)
            y = silu(gate) * val
        else:
            y = gelu_erf(y)
        return dense(y, self.fc2.weight, self.fc2.bias, self.dtype)


class LayerScale(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((width,), 1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class TimmBlock(nn.Module):
    def __init__(self, cfg: TimmViTConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.width
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = TimmAttention(d, cfg.heads, dtype)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, cfg.mlp_hidden, cfg.mlp_type == "swiglu", dtype)
        if cfg.use_layerscale:
            self.ls1, self.ls2 = LayerScale(d), LayerScale(d)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(layer_norm(self.norm1, x, self.dtype))
        x = x + (y if self.ls1 is None else self.ls1(y))
        y = self.mlp(layer_norm(self.norm2, x, self.dtype))
        return x + (y if self.ls2 is None else self.ls2(y))


class TimmViT(nn.Module):
    """``forward`` takes (B, H, W, 3) normalized float pixels (H = W =
    ``cfg.image_size``) and returns the pooled embedding in ``dtype``:
    concat(cls, patch mean) for ``pool="cls+mean"`` (Virchow2's 2560-d tile
    embedding), else cls."""

    def __init__(self, cfg: TimmViTConfig = VIRCHOW2_TIMM, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, c.width, c.patch_size, c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width))
        if c.num_registers:
            self.reg_token = nn.Parameter(torch.zeros(1, c.num_registers, c.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.pos_len, c.width))
        self.blocks = nn.ModuleList(TimmBlock(c, dtype) for _ in range(c.layers))
        self.norm = nn.LayerNorm(c.width, eps=1e-6)

    def _patches(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, grid², width): each patch flattened in (row,
        column, channel) order times the conv kernel laid out (kh, kw, cin,
        cout), plus the bias: one product in the compute dtype."""
        c = self.cfg
        b, p, g = pixels.shape[0], c.patch_size, c.grid
        patches = pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, g * g, p * p * 3)
        proj = self.patch_embed.proj
        kernel = proj.weight.permute(0, 2, 3, 1).reshape(c.width, p * p * 3)
        return dense(patches, kernel, proj.bias, self.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        with product_precision(self.dtype):
            return self._forward(pixels)

    def _forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        x = self._patches(pixels)
        b = x.shape[0]
        prefix = [self.cls_token.to(dt).expand(b, 1, c.width)]
        if c.num_registers:
            prefix.append(self.reg_token.to(dt).expand(b, c.num_registers, c.width))
        pos = self.pos_embed.to(dt)
        if c.pos_embed_mode == "patches_only":
            x = torch.cat(prefix + [x + pos], dim=1)
        else:
            x = torch.cat(prefix + [x], dim=1) + pos
        for blk in self.blocks:
            x = blk(x)
        x = layer_norm(self.norm, x, dt)
        if c.pool == "cls+mean":
            mean = x[:, 1 + c.num_registers:].float().mean(dim=1).to(dt)
            return torch.cat([x[:, 0], mean], dim=-1)
        return x[:, 0]


def init_weights(vit: TimmViT, gen: torch.Generator) -> None:
    """Seeded random weights, drawn on ``gen``'s device: dense and patch
    kernels N(0, 1 / fan_in) (flax's lecun scale), the position embedding
    N(0, 0.02), the cls and register tokens N(0, 0.02), biases N(0, 0.02),
    LayerNorm scales N(1, 0.02), and LayerScale gammas N(0.1, 0.02) (a
    trained tower's order, where timm's 1e-5 start would leave the blocks
    all but silent), so that a check on the forward sees every one of
    them."""
    dev = gen.device
    with torch.no_grad():
        for name, p in vit.named_parameters():
            r = torch.randn(p.shape, generator=gen, device=dev)
            if name.endswith("gamma"):
                v = r * 0.02 + 0.1
            elif p.ndim == 1:
                is_scale = name.endswith("weight")  # LayerNorm scales; Linear weights are 2-D
                v = r * 0.02 + (1.0 if is_scale else 0.0)
            elif name in ("cls_token", "reg_token", "pos_embed"):
                v = r * 0.02
            else:  # (out, in, ...) torch layout
                v = r * p[0].numel() ** -0.5
            p.copy_(v)


def seeded_vit(cfg: TimmViTConfig, seed: int, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> TimmViT:
    """A ``TimmViT`` on ``device`` with ``init_weights`` from a generator on
    that device seeded with ``seed`` (the same seed gives other weights on
    another device type); nothing is drawn on the host."""
    device = torch.device(device)
    with torch.device("meta"):
        vit = TimmViT(cfg, dtype)
    vit = vit.to_empty(device=device).eval()
    init_weights(vit, torch.Generator(device).manual_seed(seed))
    return vit
