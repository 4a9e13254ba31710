"""The published hover_next layout: a timm ConvNeXtV2 encoder shared by one
smp U-Net decoder and one smp segmentation head per output branch.

Counterpart of the JAX package's ``models/hovernext_real.py``. The
module names are the published checkpoint's own (smp's
``TimmUniversalEncoder`` holds timm's model as ``encoder.model``; smp's
``UnetDecoder`` blocks are ``decoder_X.blocks.N.conv{1,2}.{0,1}``, Conv3x3
without bias + BatchNorm; a head is ``head_X.0``, Conv3x3 then an
align-corners bilinear upsample), so ``state_dict()`` is what the JAX
package's ``convert_real_hovernext`` reads, and a published checkpoint
loads with ``load_state_dict(strict=True)`` once its prefixes are
normalised (``models/weights_hovernext_real.py``).

Public layouts are the JAX package's: pixels (B, H, W, 3) in [0, 1], maps
NHWC, ``{head_name: f32 logits}`` at input resolution. The encoder blocks
are plain torch ops (the JAX package runs this encoder without its fused
block), and so are the decoders and heads: convolutions through cuDNN,
BatchNorm and ReLU as elementwise ops. No hand-written kernel runs in the
forward.

Rounding follows the flax module in bf16: BatchNorm is ``x * inv + shift``
with ``inv`` and ``shift`` formed in f32 from the f32 statistics and each
cast once to the activation dtype (neither ``F.batch_norm`` nor folded into
the conv); the statistics stay f32 whatever dtype the model is moved to,
as flax keeps its parameters. The align-corners upsample forms its source
positions in f32 and its weights in the activation dtype. A skip is cast
before the concatenation; heads are cast to f32 at the end.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from path_gene_multimodal_tpu_torch.config import REAL_HOVERNEXT_PANNUKE, RealHoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.convnext import Conv2dNHWC, TimmConvNeXtV2
from path_gene_multimodal_tpu_torch.models.hovernext import init_weights as _init_convs
from path_gene_multimodal_tpu_torch.ops.decoder import upsample2x_nearest


def upsample_bilinear_align_corners(x: torch.Tensor, factor: int) -> torch.Tensor:
    """torch ``nn.UpsamplingBilinear2d`` (align_corners=True) of an NHWC
    tensor, computed as the JAX package computes it: per axis, source
    positions in f32, weights ``frac`` cast to ``x``'s dtype, and
    ``x[i0] * (1 - frac) + x[i1] * frac`` in that dtype."""

    def axis_up(t: torch.Tensor, size: int, axis: int) -> torch.Tensor:
        out = size * factor
        step = torch.tensor((size - 1) / max(out - 1, 1), dtype=torch.float32)
        src = torch.arange(out, dtype=torch.float32) * step
        i0 = torch.floor(src).to(torch.int64)
        i1 = torch.clamp(i0 + 1, max=size - 1)
        frac = (src - i0.to(torch.float32)).to(t.dtype)
        shape = [1, 1, 1, 1]
        shape[axis] = out
        frac = frac.reshape(shape).to(t.device)
        i0, i1 = i0.to(t.device), i1.to(t.device)
        return t.index_select(axis, i0) * (1 - frac) + t.index_select(axis, i1) * frac

    x = axis_up(x, x.shape[1], 1)
    return axis_up(x, x.shape[2], 2)


class BatchNormInference(nn.BatchNorm2d):
    """Eval-mode BatchNorm of an NHWC tensor as the JAX package computes it
    (``x * bf16(scale / sqrt(var + eps)) + bf16(bias - mean * scale /
    sqrt(var + eps))`` in a bf16 model). ``nn.BatchNorm2d`` only holds the
    buffers the checkpoint names; they stay f32 when the module is moved
    to another dtype (a move changes their device only)."""

    def _apply(self, fn, recurse=True):
        device = fn(torch.zeros(1, device=self.running_mean.device)).device
        return super()._apply(lambda t: t.to(device), recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = torch.sqrt(self.running_var.float() + self.eps)
        w, b = self.weight.float(), self.bias.float()
        inv = (w / root).to(x.dtype)
        shift = (b - self.running_mean.float() * w / root).to(x.dtype)
        return x * inv + shift


class SMPConvBNReLU(nn.Sequential):
    """smp ``Conv2dReLU`` with batch norm: Conv3x3 (no bias) → BN → ReLU,
    keys ``.0`` (conv) and ``.1`` (BN)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(Conv2dNHWC(cin, cout, 3, padding=1, bias=False),
                         BatchNormInference(cout), nn.ReLU())


class SMPDecoderBlock(nn.Module):
    """smp ``DecoderBlock``: nearest 2x → concat skip → conv1 → conv2."""

    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.conv1 = SMPConvBNReLU(cin + skip, cout)
        self.conv2 = SMPConvBNReLU(cout, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
        x = upsample2x_nearest(x)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.conv2(self.conv1(x))


class SMPUnetDecoder(nn.Module):
    """smp ``UnetDecoder`` over the stride-4 ConvNeXt stem: the blocks take
    the skips [/16, /8, /4], then run without one to /2."""

    def __init__(self, dims: tuple[int, ...], channels: tuple[int, ...]):
        super().__init__()
        skips = [dims[2], dims[1], dims[0]] + [0] * (len(channels) - 3)
        ins = [dims[-1]] + list(channels[:-1])
        self.blocks = nn.ModuleList(
            SMPDecoderBlock(i, s, o) for i, s, o in zip(ins, skips, channels))

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        x = feats[-1]
        skips = list(feats[-2::-1]) + [None] * (len(self.blocks) - len(feats) + 1)
        for blk, skip in zip(self.blocks, skips):
            x = blk(x, skip)
        return x


class SMPSegmentationHead(nn.Sequential):
    """smp ``SegmentationHead``: Conv3x3 (key ``.0``) → align-corners
    bilinear x ``upsampling``."""

    def __init__(self, cin: int, cout: int, upsampling: int = 2):
        super().__init__(Conv2dNHWC(cin, cout, 3, padding=1))
        self.upsampling = upsampling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        if self.upsampling > 1:
            x = upsample_bilinear_align_corners(x, self.upsampling)
        return x


class TimmUniversalEncoder(nn.Module):
    """smp's wrapper: the timm model as ``.model``."""

    def __init__(self, cfg):
        super().__init__()
        self.model = TimmConvNeXtV2(cfg)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.model(x)


class RealHoverNeXt(nn.Module):
    """Shared encoder, one (decoder, head) pair per branch, decoders shared
    where branches name the same one. ``forward`` returns {head_name:
    (B, H, W, C) f32} at input resolution. An f32 model runs its
    convolutions with cuDNN's TF32 off, scoped to the forward, as
    ``HoverNeXt`` does."""

    def __init__(self, cfg: RealHoverNeXtConfig = REAL_HOVERNEXT_PANNUKE):
        super().__init__()
        self.cfg = cfg
        self.encoder = TimmUniversalEncoder(cfg.encoder)
        for dec, head, ch in cfg.branches:
            if not hasattr(self, dec):
                self.add_module(dec, SMPUnetDecoder(cfg.encoder.dims, cfg.decoder_channels))
            self.add_module(head, SMPSegmentationHead(cfg.decoder_channels[-1], ch,
                                                      cfg.head_upsampling))

    @property
    def decoder_names(self) -> list[str]:
        return list(dict.fromkeys(d for d, _, _ in self.cfg.branches))

    def _f32_convs(self):
        if self.encoder.model.stem[0].weight.dtype != torch.float32:
            return contextlib.nullcontext()
        cudnn = torch.backends.cudnn
        return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic, allow_tf32=False)

    def heads(self, decoded: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Decoder maps (by decoder name) → {head_name: f32 logits}."""
        return {head: getattr(self, head)(decoded[dec]).float()
                for dec, head, _ in self.cfg.branches}

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        with self._f32_convs():
            feats = self.encoder(pixels.to(self.encoder.model.stem[0].weight.dtype))
            return self.heads({d: getattr(self, d)(feats) for d in self.decoder_names})


def init_weights(model: nn.Module, generator: torch.Generator,
                 bn_stats: bool = False) -> nn.Module:
    """Random weights drawn from ``generator`` (``models.hovernext.
    init_weights``: convs and linears uniform in +-1/sqrt(fan_in), norms at
    identity, GRN at zero). ``bn_stats`` also draws each BatchNorm's
    running mean from N(0, 0.3^2) and its variance from U(0.2, 2.2), so
    that BatchNorm is not the identity."""
    _init_convs(model, generator)
    if bn_stats:
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, BatchNormInference):
                    n = mod.num_features
                    mod.running_mean.copy_(torch.randn(n, generator=generator) * 0.3)
                    mod.running_var.copy_(torch.rand(n, generator=generator) * 2 + 0.2)
    return model
