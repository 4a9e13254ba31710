"""HoverNeXt nuclei segmentation model: ConvNeXtV2 encoder + U-Net decoder
+ NP/HV/TP heads, and rotation test-time augmentation.

Counterpart of the JAX package's ``models/hovernext.py`` (``HoverNeXt``,
``hv_rot_invert``, ``tta_forward``). Parameter names follow the torch
layout that the JAX package's ``convert_hovernext`` reads
(``models/weights_hovernext.py:10-17``), so ``state_dict()`` converts with
nothing left over. The final stage is the plain bilinear 2x resize + 3x3
conv + GELU + 1x1 heads, which the JAX package proves equal to its default
low-res composite (``tests/test_hovernext_fused.py:258``).

Public layouts are the JAX package's: pixels (B, H, W, 3) in [0, 1], maps
NHWC. Convs run on the NCHW view of NHWC (channels-last) tensors.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.convnext import Conv2dNHWC, ConvNeXtV2, LayerNormNHWC
from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu

FINAL_CHUNK = 128  # images per final-stage call (see HoverNeXt._final)


def _resize2x(x: torch.Tensor, mode: str) -> torch.Tensor:
    """2x upsample of an NHWC map (``jax.image.resize`` semantics: nearest,
    or bilinear with half-pixel centres and edge clamping)."""
    kw = {"align_corners": False} if mode == "bilinear" else {}
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode=mode, **kw).permute(0, 2, 3, 1)


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, exact_gelu: bool = False):
        super().__init__()
        self.conv0 = Conv2dNHWC(in_ch + skip_ch, out_ch, 3, padding=1)
        self.norm0 = LayerNormNHWC(out_ch)
        self.conv1 = Conv2dNHWC(out_ch, out_ch, 3, padding=1)
        self.norm1 = LayerNormNHWC(out_ch)
        self.exact_gelu = exact_gelu

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
        x = _resize2x(x, "nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        x = gelu(self.norm0(self.conv0(x)), self.exact_gelu)
        return gelu(self.norm1(self.conv1(x)), self.exact_gelu)


class HoverNeXt(nn.Module):
    def __init__(self, cfg: HoverNeXtConfig = HOVERNEXT_TINY):
        super().__init__()
        self.cfg = cfg
        d, dec = cfg.encoder.dims, cfg.decoder_dims
        self.encoder = ConvNeXtV2(cfg.encoder)
        skip_chs = [d[2], d[1], d[0], 0]
        in_chs = [d[-1]] + list(dec[:-1])
        self.decoder = nn.ModuleList(
            DecoderBlock(i, s, o, cfg.exact_gelu) for i, s, o in zip(in_chs, skip_chs, dec)
        )
        self.final_conv = Conv2dNHWC(dec[-1], dec[-1], 3, padding=1)
        self.head_np = Conv2dNHWC(dec[-1], 2, 1)
        self.head_hv = Conv2dNHWC(dec[-1], 2, 1)
        self.head_tp = Conv2dNHWC(dec[-1], cfg.tp_channels, 1)

    def _decode(self, pixels: torch.Tensor) -> torch.Tensor:
        """Encoder + U-Net decoder → the half-resolution map, NHWC."""
        feats = self.encoder(pixels.to(self.final_conv.weight.dtype))
        x = feats[-1]
        for blk, skip in zip(self.decoder, [feats[2], feats[1], feats[0], None]):
            x = blk(x, skip)
        return x

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        """Bilinear 2x + final 3x3 conv + GELU → the shared pre-head map.
        Runs over FINAL_CHUNK images at a time: the full-resolution map of
        a TTA x4 batch of 128 tiles (512 x 256 x 256 x 64) passes INT_MAX
        elements, more than one upsample call takes."""
        return torch.cat([
            gelu(self.final_conv(_resize2x(c, "bilinear")), self.cfg.exact_gelu)
            for c in x.split(FINAL_CHUNK)
        ])

    def features(self, pixels: torch.Tensor) -> torch.Tensor:
        """The shared pre-head map (post-GELU final conv), NHWC."""
        return self._final(self._decode(pixels))

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        """pixels (B, H, W, 3) in [0, 1] → {"np", "hv", "tp"} NHWC f32
        logits / regression at input resolution."""
        heads = (("np", self.head_np), ("hv", self.head_hv), ("tp", self.head_tp))
        parts = [
            {name: head(f).float() for name, head in heads}
            for f in (self._final(c) for c in self._decode(pixels).split(FINAL_CHUNK))
        ]
        return {name: torch.cat([p[name] for p in parts]) for name, _ in heads}


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator``: conv/linear weights and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)); norms at identity; GRN at
    zero (the JAX package's GRN init)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                bound = fan_in ** -0.5
                nn.init.uniform_(mod.weight, -bound, bound, generator=generator)
                if mod.bias is not None:
                    nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
    return model


def hv_rot_invert(h: torch.Tensor, v: torch.Tensor, k: int):
    """Swap/negate HV components back into the slide frame after undoing a
    rot90-by-k augmentation (the JAX package's sign table)."""
    k = k % 4
    if k == 1:
        return -v, h
    if k == 2:
        return -h, -v
    if k == 3:
        return v, -h
    return h, v


def _tta_invert(out: dict[str, torch.Tensor], k: int) -> dict[str, torch.Tensor]:
    rot = lambda t: torch.rot90(t, -k, dims=(1, 2))  # noqa: E731
    hv = rot(out["hv"])
    h, v = hv_rot_invert(hv[..., 0], hv[..., 1], k)
    return {"np": rot(out["np"]), "hv": torch.stack([h, v], dim=-1), "tp": rot(out["tp"])}


def tta_forward(model, pixels: torch.Tensor, tta: int = 4) -> dict[str, torch.Tensor]:
    """Rotation TTA over {0, 90, 180, 270} degrees, the rotations folded
    into ONE forward of batch tta*B (the JAX package's ``fold_batch=True``),
    inverse-transformed and averaged."""
    if tta <= 1:
        return model(pixels)
    b = pixels.shape[0]
    stacked = torch.cat([torch.rot90(pixels, k, dims=(1, 2)) for k in range(tta)], dim=0)
    out = model(stacked)
    parts = [_tta_invert({n: t[k * b : (k + 1) * b] for n, t in out.items()}, k)
             for k in range(tta)]
    return {n: sum(p[n] for p in parts) / tta for n in parts[0]}
