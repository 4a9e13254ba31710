"""ConvNeXtV2 encoder, the backbone of HoverNeXt.

Counterpart of the JAX package's ``models/convnext.py`` and of the encoder
half of ``models/hovernext_fn.py``. Module and parameter names follow the
official FCMAE ConvNeXtV2 layout (``downsample_layers`` / ``stages`` /
``dwconv`` / ``grn``) that the JAX package's ``convert_convnextv2`` reads,
so a ``state_dict`` of this module converts with nothing left over.

Activations are NHWC between blocks. After ``ConvNeXtV2.fuse()`` the
blocks of stages 0-2 (the JAX package's ``DEFAULT_FUSED_STAGES``) run as
one K1 call each (``ops/convnext_block.py``); the others, and every block
of an unfused encoder, run as plain torch ops, like the JAX package's
``_block_unfused``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.config import CONVNEXTV2_TINY, ConvNeXtConfig
from path_gene_multimodal_tpu_torch.ops.convnext_block import check_channels, convnext_block, gelu

DEFAULT_FUSED_STAGES = (0, 1, 2)


def on_card(module: nn.Module) -> bool:
    """True when ``module``'s weights lie on a CUDA device, where its
    kernels run (on the CPU they run their plain versions)."""
    return next(module.parameters()).is_cuda


class LayerNormNHWC(nn.Module):
    """LayerNorm over the last (channel) axis, statistics in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class Conv2dNHWC(nn.Conv2d):
    """``nn.Conv2d`` over NHWC tensors (the NCHW view of an NHWC tensor is
    channels-last in memory, so the permutes cost no copy)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def grn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Global Response Normalization (ConvNeXtV2) of an NHWC ``x``; gamma
    and beta broadcast over the channel axis, (C,) or (1, 1, 1, C)."""
    gx = torch.sqrt(x.float().square().sum(dim=(1, 2), keepdim=True) + 1e-12)
    nx = (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
    return gamma.to(x.dtype) * (x * nx) + beta.to(x.dtype) + x


class GRN(nn.Module):
    """GRN with the FCMAE layout's (1, 1, 1, C) vectors."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return grn(x, self.gamma, self.beta)


def block_forward(x: torch.Tensor, dw: nn.Module, norm: nn.Module, fc1: nn.Module,
                  grn_mod: nn.Module, fc2: nn.Module, exact_gelu: bool) -> torch.Tensor:
    """A ConvNeXtV2 block as plain torch ops: dw 7x7 → LN → pw 4x → GELU →
    GRN → pw → residual, whatever names its modules have."""
    y = norm(dw(x))
    y = gelu(fc1(y), exact_gelu)
    return x + fc2(grn_mod(y))


class Block(nn.Module):
    def __init__(self, dim: int, exact_gelu: bool = False):
        super().__init__()
        self.dwconv = Conv2dNHWC(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNormNHWC(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.exact_gelu = exact_gelu
        self.k1_weights: tuple[torch.Tensor, ...] | None = None  # set by ConvNeXtV2.fuse

    @torch.no_grad()
    def kernel_weights(self) -> tuple[torch.Tensor, ...]:
        """The block's weights as K1 takes them: bf16, dw (7, 7, C), w1
        (C, 4C), w2 (4C, C), the vectors flat; all contiguous but w1 and
        w2, which are the transposes of contiguous tensors (nn.Linear's
        (out, in) layout: K contiguous, the kernel's B operand)."""
        ws = (self.dwconv.weight[:, 0].permute(1, 2, 0), self.dwconv.bias, self.norm.weight,
              self.norm.bias, self.pwconv1.weight, self.pwconv1.bias,
              self.grn.gamma.reshape(-1), self.grn.beta.reshape(-1), self.pwconv2.weight,
              self.pwconv2.bias)
        ws = [t.detach().to(torch.bfloat16).contiguous() for t in ws]
        ws[4], ws[8] = ws[4].t(), ws[8].t()
        return tuple(ws)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) → same; one K1 call (bf16 inside) once fused."""
        if self.k1_weights is not None:
            return convnext_block(x.to(torch.bfloat16), *self.k1_weights,
                                  exact_gelu=self.exact_gelu).to(x.dtype)
        return block_forward(x, self.dwconv, self.norm, self.pwconv1, self.grn, self.pwconv2,
                             self.exact_gelu)


class ConvNeXtV2(nn.Module):
    """Returns the stage features [/4, /8, /16, /32], NHWC."""

    def __init__(self, cfg: ConvNeXtConfig = CONVNEXTV2_TINY):
        super().__init__()
        d = cfg.dims
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(Conv2dNHWC(3, d[0], 4, stride=4), LayerNormNHWC(d[0]))]
            + [
                nn.Sequential(LayerNormNHWC(d[s - 1]), Conv2dNHWC(d[s - 1], d[s], 2, stride=2))
                for s in range(1, cfg.num_stages)
            ]
        )
        self.stages = nn.ModuleList(
            nn.Sequential(*[Block(d[s], cfg.exact_gelu) for _ in range(cfg.depths[s])])
            for s in range(cfg.num_stages)
        )

    def fuse(self) -> None:
        """Run the blocks of ``DEFAULT_FUSED_STAGES`` as K1 from now on, with
        their weights held once in the kernel's layout. Call it when the
        weights, device and dtype are final: later changes do not reach K1.
        With the weights on the card, refuses a stage whose width K1's
        kernel cannot take (``ops/convnext_block.py::check_channels``)."""
        if on_card(self):
            for s in DEFAULT_FUSED_STAGES:
                check_channels(self.stages[s][0].dwconv.in_channels, f"encoder stage {s}")
        for s in DEFAULT_FUSED_STAGES:
            for blk in self.stages[s]:
                blk.k1_weights = blk.kernel_weights()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
            feats.append(x)
        return feats


# -- the same encoder under timm's names ---------------------------------------
# The published hover_next checkpoint holds its encoder as smp's
# TimmUniversalEncoder around timm's ConvNeXtV2: ``stem.{0,1}``,
# ``stages.S.downsample.{0,1}`` (S >= 1), ``stages.S.blocks.B.{conv_dw,
# norm, mlp.fc1, mlp.grn, mlp.fc2}``, the GRN vectors (4C,). The modules
# below compute what ``ConvNeXtV2``'s plain blocks compute, under those
# names; they are never fused (the JAX package runs this encoder plain).


class TimmGRN(nn.Module):
    """GRN with timm's (C,) ``weight`` and ``bias``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return grn(x, self.weight, self.bias)


class TimmMlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.grn = TimmGRN(4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class TimmBlock(nn.Module):
    def __init__(self, dim: int, exact_gelu: bool = False):
        super().__init__()
        self.conv_dw = Conv2dNHWC(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNormNHWC(dim)
        self.mlp = TimmMlp(dim)
        self.exact_gelu = exact_gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.mlp
        return block_forward(x, self.conv_dw, self.norm, m.fc1, m.grn, m.fc2, self.exact_gelu)


class TimmStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool, exact_gelu: bool):
        super().__init__()
        self.downsample = (
            nn.Sequential(LayerNormNHWC(in_dim), Conv2dNHWC(in_dim, dim, 2, stride=2))
            if downsample else nn.Identity()
        )
        self.blocks = nn.Sequential(*[TimmBlock(dim, exact_gelu) for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class TimmConvNeXtV2(nn.Module):
    """``ConvNeXtV2`` under timm's names: returns [/4, /8, /16, /32], NHWC."""

    def __init__(self, cfg: ConvNeXtConfig = CONVNEXTV2_TINY):
        super().__init__()
        d = cfg.dims
        self.stem = nn.Sequential(Conv2dNHWC(3, d[0], 4, stride=4), LayerNormNHWC(d[0]))
        self.stages = nn.ModuleList(
            TimmStage(d[max(s - 1, 0)], d[s], cfg.depths[s], s > 0, cfg.exact_gelu)
            for s in range(cfg.num_stages)
        )

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats
