"""K1: the ConvNeXtV2 block (dw 7x7 + LN + pw1 + GELU + GRN + pw2 +
residual) as one kernel call.

Counterpart of the JAX package's ``ops/pallas/convnext_block.py``
(``fused_convnext_block``). On a CUDA tensor ``convnext_block`` launches
the hand-written kernel in ``csrc/convnext_block.cu``; on a CPU tensor it
runs ``convnext_block_plain``, which repeats the TPU kernel's arithmetic
op for op (bf16 storage, f32 accumulation, bf16 rounding of each pointwise
product's operand), and also rounds the GELU output y2 to bf16 before the
GRN affine, where the CUDA kernel stores it between its two launches (the
GRN sums of squares stay on the f32 values, in both).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.ops import cuda

KERNEL_SIZE = 7
PAD = KERNEL_SIZE // 2


def gelu(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """GELU in the flavor the config selects (tanh unless ``exact``)."""
    return F.gelu(x, approximate="none" if exact else "tanh")


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz-Stegun 7.1.26, as the TPU kernel computes it."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_kernel(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """GELU as the TPU kernels compute it: tanh, or exact through the
    Abramowitz-Stegun erf polynomial (not ``torch.erf``)."""
    if exact:
        return 0.5 * x * (1.0 + _erf_as(x * 0.7071067811865476))
    k = 0.7978845608028654
    return 0.5 * x * (1.0 + torch.tanh(k * (x + 0.044715 * x * x * x)))


def convnext_block_plain(
    x, dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2,
    exact_gelu: bool = False,
) -> torch.Tensor:
    """x (B, H, W, C) → block output (B, H, W, C) bf16. Weights as the JAX
    kernel takes them: dw (7, 7, C), w1 (C, 4C), w2 (4C, C), vectors (C,)
    or (4C,)."""
    bf = torch.bfloat16
    f = lambda t: t.to(bf).float()  # noqa: E731
    b, h, w, c = x.shape
    xf = f(x)
    dwk = f(dw)
    xp = F.pad(xf, (0, 0, PAD, PAD, PAD, PAD))
    acc = torch.zeros_like(xf)
    for dx in range(KERNEL_SIZE):
        for dy in range(KERNEL_SIZE):
            acc = acc + xp[:, dy : dy + h, dx : dx + w, :] * dwk[dy, dx]
    acc = acc + f(dwb)
    mu = acc.mean(-1, keepdim=True)
    var = (acc - mu).square().mean(-1, keepdim=True)
    y = (acc - mu) * torch.rsqrt(var + 1e-6) * f(ln_gamma) + f(ln_beta)
    y2 = f(y).reshape(-1, c) @ f(w1) + f(b1)
    y2 = gelu_kernel(y2, exact_gelu).reshape(b, h * w, 4 * c)
    gx = torch.sqrt(y2.square().sum(1, keepdim=True) + 1e-12)
    nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
    y3 = f(y2) * (f(grn_gamma) * nx + 1.0) + f(grn_beta)
    y4 = f(y3).reshape(-1, 4 * c) @ f(w2) + f(b2)
    return (xf + y4.reshape(b, h, w, c)).to(bf)


def convnext_block(
    x, dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2,
    exact_gelu: bool = False,
) -> torch.Tensor:
    """ConvNeXtV2 block on (B, H, W, C) → bf16 (B, H, W, C): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor. The kernel
    takes its weights as ``Block.kernel_weights`` holds them (bf16,
    contiguous, the plain version's shapes) and raises on anything else."""
    if not x.is_cuda:
        return convnext_block_plain(
            x, dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2,
            exact_gelu,
        )
    b, h, w, c = x.shape
    if c % 16 or c > 384:
        raise ValueError(f"convnext_block kernel takes C % 16 == 0 and C <= 384, got {c}")
    bf = torch.bfloat16
    xb = x if x.dtype == bf else x.to(bf)
    xb = xb.contiguous()
    wt = (dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2)
    shapes = [(KERNEL_SIZE, KERNEL_SIZE, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,),
              (4 * c,), (4 * c,), (4 * c, c), (c,)]
    cuda.check(xb, "x", bf, (b, h, w, c))
    for i, (t, s) in enumerate(zip(wt, shapes)):
        cuda.check(t, f"weight {i}", bf, s)
    y2 = torch.empty((b, h * w, 4 * c), dtype=bf, device=x.device)
    gsum = torch.zeros((b, 4 * c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(xb)
    cuda.launch(
        "convnext_block", "convnext_block_launch",
        cuda.ptr(xb), *[cuda.ptr(t) for t in wt], cuda.ptr(y2), cuda.ptr(gsum),
        cuda.ptr(out), b, h, w, c, int(exact_gelu), cuda.stream(),
    )
    convnext_block.launches += 1
    return out


convnext_block.launches = 0
