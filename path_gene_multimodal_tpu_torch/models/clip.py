"""CLIP image and text towers: the tile and class embedding models.

Counterpart of the JAX package's ``models/clip.py``: ``VisionConfig`` and
its presets, ``VisionTower`` (conv patchify, cls token, optional register
tokens, learned position embedding, ln_pre, pre-LN transformer, ln_post,
linear projection; ``cls`` or ``cls+mean`` pooling), ``preprocess_tiles``,
``ImageEncoder``; ``TextConfig``, ``CLIP_TEXT``, ``TextTower`` (token and
position embeddings, causal pre-LN transformer with quick_gelu,
``ln_final``, features at the EOT token, projection) and ``TextEncoder``.
The towers' ``state_dict()`` have the names of OpenAI CLIP that the JAX
package's ``convert_clip_vision`` / ``convert_clip_text`` read: ``visual.*``
(register tokens, which no OpenAI checkpoint has, as
``visual.register_tokens``) and ``token_embedding``,
``positional_embedding``, ``transformer.*``, ``ln_final``,
``text_projection``.

Rounding follows flax (``models/layers.py``): the patch embed is a bf16
product with f32 accumulation, ``x + pos`` adds in the compute dtype (the
position embedding rounded first), and the output is cast to f32.

``ImageEncoder`` also takes a ``models.vit_timm.TimmViTConfig``: the real
Virchow2 tower, a timm ViT (``models/vit_timm.py``), and a ``mesh``
(``parallel/mesh.py``): the tower replicated on each of its devices, each
batch split over its shards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from path_gene_multimodal_tpu_torch.models.layers import (
    Transformer,
    dense,
    gelu_tanh,
    layer_norm,
    product_precision,
    quick_gelu,
)
from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViT, TimmViTConfig, seeded_vit
from path_gene_multimodal_tpu_torch.parallel.mesh import Mesh, gather, replicate, run_sharded

# CLIP preprocessing constants (OpenAI; used by Mussel's feature extractor)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# ImageNet constants (Virchow2 path)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    out_dim: int | None = 512      # projection dim (None = return pooled width)
    num_registers: int = 0          # Virchow2-style register tokens
    mlp_ratio: float = 4.0
    use_quick_gelu: bool = True
    pool: str = "cls"               # "cls" | "cls+mean" (Virchow2 concat)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return 1 + self.num_registers + self.grid * self.grid


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    out_dim: int = 512


# Named presets for the reference's MODEL_TYPE values.
CLIP_VIT_B16 = VisionConfig()
CLIP_VIT_B32 = VisionConfig(patch_size=32)
CLIP_VIT_L14 = VisionConfig(patch_size=14, width=1024, layers=24, heads=16, out_dim=768)
VIRCHOW2 = VisionConfig(
    patch_size=14, width=1280, layers=32, heads=16, out_dim=None,
    num_registers=4, use_quick_gelu=False, pool="cls+mean",
)
CLIP_TEXT = TextConfig()


class VisionTower(nn.Module):
    """ViT image encoder in the CLIP layout. ``forward`` takes (B, H, W, 3)
    normalized float pixels (H = W = ``cfg.image_size``) and returns (B, D)
    in ``dtype``. Parameters stay f32; ``dtype`` is the compute dtype."""

    def __init__(self, cfg: VisionConfig = CLIP_VIT_B16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg
        v = self.visual = nn.Module()
        v.conv1 = nn.Conv2d(3, c.width, c.patch_size, c.patch_size, bias=False)
        v.class_embedding = nn.Parameter(torch.zeros(c.width))
        if c.num_registers:
            v.register_tokens = nn.Parameter(torch.zeros(c.num_registers, c.width))
        v.positional_embedding = nn.Parameter(torch.zeros(c.seq_len, c.width))
        v.ln_pre = nn.LayerNorm(c.width, eps=1e-5)
        v.transformer = Transformer(c.width, c.layers, c.heads, c.mlp_ratio,
                                    quick_gelu if c.use_quick_gelu else gelu_tanh, dtype)
        v.ln_post = nn.LayerNorm(c.width, eps=1e-5)
        if c.out_dim is not None:
            v.proj = nn.Parameter(torch.zeros(c.width, c.out_dim))  # (width, out), as OpenAI

    def patch_embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, grid², width): each patch flattened in (row,
        column, channel) order, times the conv kernel laid out (kh, kw, cin,
        cout) as flax holds it: one product in the compute dtype."""
        c = self.cfg
        b, p, g = pixels.shape[0], c.patch_size, c.grid
        patches = pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, g * g, p * p * 3)
        kernel = self.visual.conv1.weight.permute(0, 2, 3, 1).reshape(c.width, p * p * 3)
        return dense(patches, kernel, None, self.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        with product_precision(self.dtype):
            return self._forward(pixels)

    def _forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c, v, dt = self.cfg, self.visual, self.dtype
        x = self.patch_embed(pixels)
        b = x.shape[0]
        tokens = [v.class_embedding.to(dt).expand(b, 1, c.width)]
        if c.num_registers:
            tokens.append(v.register_tokens.to(dt).expand(b, c.num_registers, c.width))
        x = torch.cat(tokens + [x], dim=1)
        x = x + v.positional_embedding.to(dt)
        x = layer_norm(v.ln_pre, x, dt)
        x = v.transformer(x)
        if c.pool == "cls+mean":
            # Virchow2 embedding: concat(cls, mean of patch tokens)
            x = layer_norm(v.ln_post, x, dt)
            pooled = torch.cat([x[:, 0], x[:, 1 + c.num_registers :].mean(dim=1)], dim=-1)
        else:
            pooled = layer_norm(v.ln_post, x[:, 0], dt)
        if c.out_dim is not None:
            pooled = dense(pooled, v.proj.t(), None, dt)
        return pooled


class TextTower(nn.Module):
    """CLIP text encoder: token + position embeddings, causal pre-LN
    transformer, final LayerNorm, features taken at the EOT token (the
    highest token id; its first position), projection. ``forward`` takes
    (B, L) int ids, L <= ``context_length``, and returns (B, out_dim) in
    ``dtype``."""

    def __init__(self, cfg: TextConfig = CLIP_TEXT, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.positional_embedding = nn.Parameter(torch.zeros(c.context_length, c.width))
        self.transformer = Transformer(c.width, c.layers, c.heads, c.mlp_ratio, quick_gelu, dtype)
        self.ln_final = nn.LayerNorm(c.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(c.width, c.out_dim))  # (width, out)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        with product_precision(self.dtype):
            dt = self.dtype
            b, n = ids.shape
            x = self.token_embedding.weight.to(dt)[ids.long()]
            x = x + self.positional_embedding.to(dt)[:n]
            causal = torch.triu(torch.full((n, n), float("-inf"), device=ids.device), 1)
            x = self.transformer(x, causal)
            x = layer_norm(self.ln_final, x, dt)
            eot = torch.argmax(ids, dim=-1)  # EOT has the highest id in CLIP's vocab
            pooled = x[torch.arange(b, device=ids.device), eot]
            return dense(pooled, self.text_projection.t(), None, dt)


def init_weights(tower: nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: kernels N(0, 1/fan_in) (flax's lecun scale),
    token and position embeddings N(0, 0.02) / N(0, 0.01) (flax's
    initializers), and, unlike flax's zeros and ones, biases and LayerNorm
    vectors drawn around them too, so that a check on the forward sees
    every one of them."""
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if name.endswith(("class_embedding", "register_tokens", "token_embedding.weight")):
                std, mean = 0.02, 0.0
            elif name.endswith("positional_embedding"):
                std, mean = 0.01, 0.0
            elif p.ndim == 1:
                is_scale = name.split(".")[-2].startswith("ln_") and name.endswith("weight")
                std, mean = 0.02, 1.0 if is_scale else 0.0
            elif name.endswith(("proj", "text_projection")):  # (width, out)
                std, mean = p.shape[0] ** -0.5, 0.0
            else:  # (out, in, ...) torch layout
                std, mean = (p[0].numel()) ** -0.5, 0.0
            p.copy_(torch.randn(p.shape, generator=gen) * std + mean)


def preprocess_tiles(
    tiles_u8: torch.Tensor, mean: np.ndarray = CLIP_MEAN, std: np.ndarray = CLIP_STD
) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB → normalized float32. Tiles are already the
    model's native 224 px so no resize/crop (parity with Mussel's pipeline
    feeding 224 px tiles to CLIP's 224 px input)."""
    x = tiles_u8.to(torch.float32) / 255.0
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def _triangle_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., "bilinear")`` along
    one axis (``jax._src.image.scale.compute_weight_mat``, antialias on):
    the triangle kernel, widened by in/out when shrinking, normalized per
    output sample, zero where the sample falls outside the input. f32, as
    JAX computes it."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) f32 → (B, size, size, C) as ``jax.image.resize(...,
    "bilinear")`` (antialiased when shrinking). The triangle filter is
    written out: ``F.interpolate(antialias=True)`` is not known to match it
    at the borders. An axis already at ``size`` is left as it is, as JAX
    skips it."""
    h, w = pixels.shape[1:3]
    x = pixels
    if h != size:
        x = torch.einsum("bhwc,hH->bHwc", x, _triangle_weights(h, size, x.device))
    if w != size:
        x = torch.einsum("bhwc,wW->bhWc", x, _triangle_weights(w, size, x.device))
    return x


class ImageEncoder:
    """The tower with its weights on one device, and the normalize →
    (resize) → ViT forward. A ``VisionConfig`` builds the CLIP-layout
    ``VisionTower`` (``state_dict`` in the ``visual.*`` names), a
    ``TimmViTConfig`` the timm ``TimmViT`` (timm's names; pass the ImageNet
    ``mean`` / ``std`` with it, as the Virchow2 path does). Without a
    ``state_dict`` the weights are seeded from ``seed``: the CLIP tower's
    drawn on the host, the timm tower's on ``device``. Runs on the card
    unless the caller passes ``device="cpu"``; ``dtype`` is the compute
    dtype (bf16 by default, as the JAX package's).

    With a ``mesh`` the tower is built on the mesh's first device (its
    ``device``) and copied to each other one; each batch is split on its
    leading axis over the shards, every shard's forward enqueued on its own
    device before the features are gathered, in order, on the first. A
    batch need not divide the mesh (the first shards take a row more)."""

    def __init__(
        self,
        cfg: VisionConfig | TimmViTConfig = CLIP_VIT_B16,
        state_dict: dict | None = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        mean: np.ndarray = CLIP_MEAN,
        std: np.ndarray = CLIP_STD,
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else torch.device(device)
        timm = isinstance(cfg, TimmViTConfig)
        if timm and state_dict is None:
            self.model = seeded_vit(cfg, seed, dtype, self.device)
        else:  # built on the device with no default init: every weight is set below
            with torch.device("meta"):
                model = (TimmViT if timm else VisionTower)(cfg, dtype=dtype)
            self.model = model.to_empty(device=self.device).eval()
            if state_dict is None:
                init_weights(self.model, torch.Generator().manual_seed(seed))
            else:
                self.model.load_state_dict(state_dict)
        self._mean, self._std = mean, std
        self._replicas = replicate(self.model, mesh) if mesh is not None else None

    @property
    def out_dim(self) -> int:
        """Embedding width this encoder emits — 512/768 for projected CLIP,
        width (or 2x width for cls+mean pooling, e.g. Virchow2's 2560) when
        there is no projection. Empty-slide artifacts need it to write the
        correct feature-matrix width."""
        c = self.cfg
        if getattr(c, "out_dim", None) is not None:
            return int(c.out_dim)
        return int(c.width) * (2 if c.pool == "cls+mean" else 1)

    @torch.inference_mode()
    def __call__(self, tiles_u8) -> torch.Tensor:
        """uint8 (B, H, W, 3) (numpy or torch) → (B, out_dim) f32 on the
        device, enqueued without waiting for it."""
        tiles = tiles_u8 if torch.is_tensor(tiles_u8) else torch.from_numpy(np.asarray(tiles_u8))
        if self.device.type == "cuda" and tiles.device.type == "cpu":
            tiles = tiles.pin_memory()  # so that the copy does not wait for the card
        if self.mesh is None:
            return self._forward(self.model, tiles.to(self.device, non_blocking=True))
        outs = run_sharded(self.mesh, lambda dev, t: self._forward(self._replicas[dev], t), tiles)
        return gather(outs, self.device)

    def _forward(self, model: nn.Module, tiles: torch.Tensor) -> torch.Tensor:
        pixels = preprocess_tiles(tiles, self._mean, self._std)
        s = self.cfg.image_size
        if pixels.shape[1] != s or pixels.shape[2] != s:
            # tile size ≠ model input (e.g. PATCH_SIZE overridden):
            # bilinear resize on device, as Mussel's loader does before
            # feeding CLIP (extract_embedding_from_tiles.py consumer)
            pixels = resize_bilinear(pixels, s)
        return model(pixels).to(torch.float32)


class TextEncoder:
    """The text tower with its weights on one device. ``state_dict`` (the
    OpenAI text names) or, if it is None, seeded random weights from
    ``seed``; f32 by default, as the JAX package's. Runs on the card unless
    the caller passes ``device="cpu"``."""

    def __init__(
        self,
        cfg: TextConfig = CLIP_TEXT,
        state_dict: dict | None = None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = TextTower(cfg, dtype=dtype)
        if state_dict is None:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, ids) -> torch.Tensor:
        """(B, L) int ids (numpy or torch) → (B, out_dim) f32 on the device."""
        ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids) else ids)
        ids = ids.to(self.device, torch.int64)
        L = self.cfg.context_length
        if ids.shape[1] > L:
            # the BPE tokenizer pads to CLIP's canonical 77: a smaller-
            # context checkpoint crops with EOT re-pinned at the end (CLIP's
            # truncation rule; features are read at the FIRST max-id
            # position, so an earlier EOT still wins)
            eot = ids.max(dim=1).values
            ids = ids[:, :L].clone()
            ids[:, -1] = eot
        elif ids.shape[1] < L:
            ids = torch.nn.functional.pad(ids, (0, L - ids.shape[1]))
        # out-of-vocab ids (a tokenizer wider than the checkpoint, e.g. the
        # hash fallback against a small test tower) fold into range (no-op
        # for real CLIP, where every id < vocab_size)
        ids = ids % self.cfg.vocab_size
        return self.model(ids).to(torch.float32)
