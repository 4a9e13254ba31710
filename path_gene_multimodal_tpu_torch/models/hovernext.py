"""HoverNeXt nuclei segmentation model: ConvNeXtV2 encoder + U-Net decoder
+ NP/HV/TP heads, and rotation test-time augmentation.

Counterpart of the JAX package's ``models/hovernext.py`` (``HoverNeXt``,
``hv_rot_invert``, ``tta_forward``) and of the decoder configurations of
its ``models/hovernext_fn.py::hovernext_forward``. Parameter names follow
the torch layout that the JAX package's ``convert_hovernext`` reads
(``models/weights_hovernext.py:10-17``), so ``state_dict()`` converts with
nothing left over.

Public layouts are the JAX package's: pixels (B, H, W, 3) in [0, 1], maps
NHWC. Convs run on the NCHW view of NHWC (channels-last) tensors.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models import hovernext_fn as fn
from path_gene_multimodal_tpu_torch.models.convnext import (
    Conv2dNHWC, ConvNeXtV2, LayerNormNHWC,
)
from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu
from path_gene_multimodal_tpu_torch.ops.decoder import (
    decoder_conv,
    final_conv_gelu,
    final_heads,
    upsample2x_bilinear,
    upsample2x_nearest,
    upsample_final,
)

FINAL_CHUNK = 128  # images per final-stage call (see HoverNeXt.final_stage)
FUSED_FINAL = (False, True, "lowres", "pallas", "heads")


def _bilinear2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NHWC map (``jax.image.resize`` semantics:
    half-pixel centres, edge clamping), ``F.interpolate``'s own kernel."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def _bf16(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return tuple(t.detach().to(torch.bfloat16).contiguous() for t in ts)


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, exact_gelu: bool = False):
        super().__init__()
        self.conv0 = Conv2dNHWC(in_ch + skip_ch, out_ch, 3, padding=1)
        self.norm0 = LayerNormNHWC(out_ch)
        self.conv1 = Conv2dNHWC(out_ch, out_ch, 3, padding=1)
        self.norm1 = LayerNormNHWC(out_ch)
        self.exact_gelu = exact_gelu

    @torch.no_grad()
    def kernel_weights(self) -> tuple[tuple[torch.Tensor, ...], ...]:
        """conv0 and conv1 as K7 takes them: bf16, contiguous, w (3, 3, cin,
        cout) (conv0's x and skip halves are its [:, :, :cx] and [:, :, cx:]),
        bias and LayerNorm vectors (cout,)."""
        return tuple(
            _bf16(conv.weight.permute(2, 3, 1, 0), conv.bias, norm.weight, norm.bias)
            for conv, norm in ((self.conv0, self.norm0), (self.conv1, self.norm1))
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None,
                k7_weights: tuple | None = None, lowres: bool = False) -> torch.Tensor:
        """Plain convs, or two K7 calls (bf16 out) given ``k7_weights``;
        ``lowres``: conv0 with the nearest upsample folded into the low-res
        parity domain (``hovernext_fn._dec_conv0_lowres``), plain."""
        if lowres:
            x = fn._dec_conv0_lowres(fn.conv_params(self.conv0), x, skip, self.conv0.weight.dtype)
            x = gelu(self.norm0(x), self.exact_gelu)
            return gelu(self.norm1(self.conv1(x)), self.exact_gelu)
        x = upsample2x_nearest(x)
        if k7_weights is not None:
            w0, w1 = k7_weights
            x = decoder_conv(x, skip, *w0, exact_gelu=self.exact_gelu)
            return decoder_conv(x, None, *w1, exact_gelu=self.exact_gelu)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        x = gelu(self.norm0(self.conv0(x)), self.exact_gelu)
        return gelu(self.norm1(self.conv1(x)), self.exact_gelu)


class HoverNeXt(nn.Module):
    """HoverNeXt with the decoder configurations of the JAX package's
    ``hovernext_forward``:

    - ``fused_decoder=True``: each decoder conv step through K7, then a
      bilinear 2x and the final conv + GELU through K8;
    - ``fused_final``: ``False`` the plain resize → conv → GELU → heads;
      ``True`` upsample, conv and GELU through K9, then the heads;
      ``"lowres"`` the composite-weight low-res final stage (plain torch);
      ``"pallas"`` the same through K11; ``"heads"`` upsample, conv, GELU
      and heads through K10;
    - ``lowres_decoder=True``: each decoder block's conv0 with the nearest
      upsample folded into the low-res parity domain (plain torch, exact up
      to rounding).

    ``None`` means ``False``, the plain path: the counterpart of the flax
    module, not of ``hovernext_forward``, whose default is ``"lowres"``
    (``NucleiModel.build`` asks for ``"lowres"`` in bf16, as the JAX nuclei
    stage runs ``hovernext_forward`` there). ``fused_decoder`` runs its own
    decoder and final stage, so it takes neither ``fused_final`` nor
    ``lowres_decoder``.
    Call ``fuse()`` once the weights, device and dtype are final, to hold
    the kernels' weights in their layout.

    Every configuration runs on either device at any encoder and decoder
    width, as the Pallas kernels take them: on the card each kernel runs
    its own compiled widths and K7's any route for the rest
    (``ops/decoder.py``); only a head's input past
    ``ops.decoder.HEAD_MAX_WIDTH`` channels is refused, by the kernel's
    wrapper at the first forward, naming the kernel. On the CPU every
    kernel runs its plain version.

    An f32 forward runs its convolutions with cuDNN's TF32 off
    (``torch.backends.cudnn.flags(allow_tf32=False)``, scoped to the
    forward and restored after it), so that an f32 model on the card
    computes in f32 as the reference does; f32 matrix products stay at
    torch's default, ``torch.backends.cuda.matmul.allow_tf32 = False``.
    """

    def __init__(self, cfg: HoverNeXtConfig = HOVERNEXT_TINY, fused_decoder: bool = False,
                 fused_final: bool | str | None = None, lowres_decoder: bool = False):
        super().__init__()
        if fused_decoder and (fused_final is not None or lowres_decoder):
            raise ValueError(
                "fused_decoder=True runs the whole decoder + final stage as its own kernels; "
                f"fused_final={fused_final!r} / lowres_decoder={lowres_decoder} would be "
                "silently ignored: leave both at their defaults")
        if fused_final is None:
            fused_final = False
        if fused_final not in FUSED_FINAL:
            raise ValueError(f"fused_final must be one of {FUSED_FINAL} or None, got "
                             f"{fused_final!r}")
        self.cfg = cfg
        self.fused_decoder = fused_decoder
        self.fused_final = fused_final
        self.lowres_decoder = lowres_decoder
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
        self.fused_weights: dict | None = None  # set by fuse()

    @torch.no_grad()
    def kernel_weights(self) -> dict:
        """The weights the configured decoder kernels take, in their layout:
        ``k7`` (per decoder block) and ``k8`` (final conv) for
        ``fused_decoder``; ``k9`` (final conv) for ``fused_final=True``;
        ``k10`` (final conv and concatenated heads) for ``"heads"``; ``k11``
        (``hovernext_fn.k11_weights``: composite weights folded in f32 from
        the module's weights, then cast) for ``"pallas"``."""
        kw: dict = {}
        dtype = self.final_conv.weight.dtype
        final = _bf16(self.final_conv.weight.permute(2, 3, 1, 0), self.final_conv.bias)
        if self.fused_decoder:
            kw["k7"] = [blk.kernel_weights() for blk in self.decoder]
            kw["k8"] = final
        if self.fused_final is True:
            kw["k9"] = final
        p = fn.final_params(self)
        if self.fused_final == "heads":
            wcat, bcat = fn._head_cat(p, self.final_conv.out_channels, dtype)
            kw["k10"] = _bf16(p["final_conv"]["kernel"], p["final_conv"]["bias"], wcat, bcat)
        if self.fused_final == "pallas":
            kw["k11"] = fn.k11_weights(p, dtype)
        return kw

    def fuse(self) -> None:
        """Run the encoder blocks of stages 0-2 as K1 (``ConvNeXtV2.fuse``)
        and hold the configured decoder kernels' weights once in their
        layout. Later changes to the weights, device or dtype reach neither."""
        self.encoder.fuse()
        self.fused_weights = self.kernel_weights()

    def _kw(self) -> dict:
        return self.fused_weights if self.fused_weights is not None else self.kernel_weights()

    def decode(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """Encoder features → the last decoder map (half resolution), NHWC;
        bf16 when the decoder runs through K7."""
        k7 = self._kw().get("k7", [None] * len(self.decoder))
        x = feats[-1]
        for blk, skip, w in zip(self.decoder, [feats[2], feats[1], feats[0], None], k7):
            x = blk(x, skip, w, self.lowres_decoder)
        return x

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        """Bilinear 2x + final 3x3 conv + GELU → the shared pre-head map.
        Runs over FINAL_CHUNK images at a time: the full-resolution map of
        a TTA x4 batch of 128 tiles (512 x 256 x 256 x 64) passes INT_MAX
        elements, more than one upsample call takes."""
        return torch.cat([
            gelu(self.final_conv(_bilinear2x(c)), self.cfg.exact_gelu)
            for c in x.split(FINAL_CHUNK)
        ])

    def _heads(self, f: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"np": self.head_np(f).float(), "hv": self.head_hv(f).float(),
                "tp": self.head_tp(f).float()}

    def _final_chunk(self, x: torch.Tensor, kw: dict) -> dict[str, torch.Tensor]:
        dtype = self.final_conv.weight.dtype
        exact = self.cfg.exact_gelu
        if self.fused_decoder:
            return self._heads(final_conv_gelu(upsample2x_bilinear(x), *kw["k8"],
                                               exact_gelu=exact).to(dtype))
        if self.fused_final is True:
            return self._heads(upsample_final(x, *kw["k9"], exact_gelu=exact).to(dtype))
        if self.fused_final == "heads":
            out = final_heads(x, *kw["k10"], exact_gelu=exact).float()
        elif self.fused_final == "pallas":
            out = fn._final_heads_lowres_pallas(fn.final_params(self), x, dtype, exact,
                                                kw["k11"])
        elif self.fused_final == "lowres":
            out = fn._final_heads_lowres(fn.final_params(self), x, dtype, exact)
        else:
            return self._heads(self._final(x))
        return {"np": out[..., :2], "hv": out[..., 2:4], "tp": out[..., 4:]}

    def final_stage(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """The last decoder map → {"np", "hv", "tp"} f32 at input
        resolution, over FINAL_CHUNK images at a time."""
        kw = self._kw()
        parts = [self._final_chunk(c, kw) for c in x.split(FINAL_CHUNK)]
        return {n: torch.cat([p[n] for p in parts]) for n in parts[0]}

    def features(self, pixels: torch.Tensor) -> torch.Tensor:
        """The shared pre-head map (post-GELU final conv), NHWC, through the
        plain decoder and final stage whatever ``fused_final`` says (the
        head-folded variants never build it); not with ``fused_decoder``."""
        if self.fused_decoder:
            raise ValueError("features() is not supported with fused_decoder")
        with self._f32_convs():
            feats = self.encoder(pixels.to(self.final_conv.weight.dtype))
            return self._final(self.decode(feats))

    def _f32_convs(self):
        """cuDNN without TF32 for an f32 model, scoped (see the class)."""
        if self.final_conv.weight.dtype != torch.float32:
            return contextlib.nullcontext()
        cudnn = torch.backends.cudnn
        return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic, allow_tf32=False)

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        """pixels (B, H, W, 3) in [0, 1] → {"np", "hv", "tp"} NHWC f32
        logits / regression at input resolution."""
        with self._f32_convs():
            feats = self.encoder(pixels.to(self.final_conv.weight.dtype))
            return self.final_stage(self.decode(feats))


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
