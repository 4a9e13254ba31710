"""HoverNeXt final-stage variants and the weight folds they need.

Counterpart of the final-stage half of the JAX package's
``models/hovernext_fn.py``, with its names. Parameters travel as that
module's pytrees do, ``{"final_conv": {"kernel", "bias"}, "head_np": ...}``
with HWIO kernels (``final_params`` builds one from a ``HoverNeXt``), and
maps are NHWC.

- ``_final_heads_lowres`` (the JAX default ``fused_final="lowres"``, plain
  torch): bilinear 2x∘conv3x3 folded into one low-res conv with 4 cout
  parity outputs, GELU, the heads per parity, depth-to-space, and the
  2-px border ring recomputed exactly;
- ``_final_heads_lowres_pallas`` (``fused_final="pallas"``): the same
  through K11 (``ops.decoder.composite_final_heads``), with the border ring
  recomputed here, after the kernel, in the model dtype;
- ``_dec_conv0_lowres`` (``lowres_decoder=True``, plain torch): a decoder
  block's conv0 over concat(nearest 2x of x, skip) with the upsample folded
  into one 2x2 conv in the low-res parity domain.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu
from path_gene_multimodal_tpu_torch.ops.decoder import composite_final_heads, upsample2x_bilinear

HEADS = ("head_np", "head_hv", "head_tp")


def conv_params(conv: nn.Conv2d) -> dict[str, torch.Tensor]:
    """A conv's weights as the JAX package holds them: HWIO kernel, bias."""
    return {"kernel": conv.weight.detach().permute(2, 3, 1, 0), "bias": conv.bias.detach()}


def final_params(model) -> dict[str, dict[str, torch.Tensor]]:
    return {n: conv_params(getattr(model, n)) for n in ("final_conv",) + HEADS}


def _conv2d(x, kernel, pad: int, dtype) -> torch.Tensor:
    """Conv in ``dtype``, NHWC input, HWIO kernel, zero padding ``pad``."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), kernel.to(dtype).permute(3, 2, 0, 1),
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def _conv(p, x, pad: int, dtype) -> torch.Tensor:
    """Conv in ``dtype`` (NHWC, HWIO) + bias."""
    return _conv2d(x, p["kernel"], pad, dtype) + p["bias"].to(dtype)


def _dec_conv0_lowres(dp, x, skip, dtype) -> torch.Tensor:
    """``conv0(concat(nearest_up2x(x), skip))`` without the upsampled
    tensor: nearest 2x + zero-pad SAME compose exactly, so the x-path of
    conv0 is one VALID 2x2 conv in the low-res parity domain (4 phase
    outputs on the channel axis), then depth-to-space; the skip path is a
    plain hi-res conv with the kernel's skip slice. The fold runs in f32.
    Returns the pre-LayerNorm conv0 output (B, 2H, 2W, cout)."""
    w = dp["kernel"].float()  # (3, 3, cin_total, cout)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    # per-axis fold (nearest): phase 0 2-tap = [w(-1), w(0)+w(1)],
    #                          phase 1 2-tap = [w(-1)+w(0), w(1)]
    a0 = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]], device=w.device)
    a1 = torch.tensor([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]], device=w.device)
    mats = (a0, a1)
    wc = torch.cat([torch.einsum("yxio,ty,sx->tsio", w[:, :, :cin], mats[a], mats[bb])
                    for a in (0, 1) for bb in (0, 1)], dim=-1)  # (2, 2, cin, 4 cout)
    z = _conv2d(F.pad(x, (0, 0, 1, 1, 1, 1)), wc, 0, dtype)  # (B, H+1, W+1, 4 cout)
    phases = [z[:, a : a + h, bb : bb + wd, p * cout : (p + 1) * cout]
              for p, (a, bb) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]
    y = (torch.stack(phases, dim=3).reshape(b, h, wd, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, 2 * h, 2 * wd, cout))
    if skip is not None:
        y = y + _conv2d(skip, w[:, :, cin:], 1, dtype)
    return y + dp["bias"].to(dtype)


def _head_cat(p, ch: int, dtype):
    """The (np, hv, tp) head weights as one (ch, n_out) matrix and bias."""
    wcat = torch.cat([p[n]["kernel"].reshape(ch, -1).to(dtype) for n in HEADS], dim=-1)
    bcat = torch.cat([p[n]["bias"].to(dtype) for n in HEADS])
    return wcat, bcat


def _composite_final_weights(w: torch.Tensor) -> torch.Tensor:
    """Parity-fold resize(2x, bilinear)∘conv3x3 into low-res weights (3, 3,
    cin, 4 cout), parity order (a, b) = 00, 01, 10, 11. Fold in f32."""
    m0 = torch.tensor([[0.75, 0.25, 0.0], [0.25, 0.75, 0.0], [0.0, 0.75, 0.25]],
                      dtype=w.dtype, device=w.device)
    m1 = torch.tensor([[0.25, 0.75, 0.0], [0.0, 0.75, 0.25], [0.0, 0.25, 0.75]],
                      dtype=w.dtype, device=w.device)
    mats = (m0, m1)
    return torch.cat([torch.einsum("yxio,yY,xX->YXio", w, mats[a], mats[b])
                      for a in (0, 1) for b in (0, 1)], dim=-1)


def _exact_border_heads(out, p_final, x, wcat, bcat, dtype, exact_gelu: bool = False):
    """Overwrite ``out``'s outer 2-px ring (in place) with the exact
    resize → conv → GELU → heads computation in ``dtype``: the composite
    weights assume interior interpolation. GELU is ``F.gelu`` here, as the
    JAX code's ``jax.nn.gelu``."""

    def exact(xs):
        ys = gelu(_conv(p_final, upsample2x_bilinear(xs), 1, dtype), exact_gelu)
        return ys.to(dtype) @ wcat + bcat

    out[:, :2] = exact(x[:, :4])[:, :2]
    out[:, -2:] = exact(x[:, -4:])[:, -2:]
    out[:, :, :2] = exact(x[:, :, :4])[:, :, :2]
    out[:, :, -2:] = exact(x[:, :, -4:])[:, :, -2:]
    return out


def _lowres_head_weights(p, p_final, dtype):
    """Composite conv weights (folded in f32), 4x-tiled bias, concatenated
    head matrix and bias in ``dtype``."""
    w = p_final["kernel"].float()
    wcat, bcat = _head_cat(p, w.shape[-1], dtype)
    return _composite_final_weights(w), p_final["bias"].repeat(4), wcat, bcat


def _block_diag_heads(wcat: torch.Tensor, bcat: torch.Tensor):
    """The head matrix repeated block-diagonally over the four parity
    phases, (4 cout, 4 n_out), zeros off the diagonal whatever wcat
    holds, and the 4x-tiled head bias."""
    return torch.block_diag(*[wcat] * 4), bcat.repeat(4)


def _parity_to_fullres(z: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, H, W, 4 n_out) phase-major parity logits → (B, 2H, 2W, n_out)."""
    b, h, wd = z.shape[:3]
    return (z.reshape(b, h, wd, 2, 2, n_out).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, 2 * h, 2 * wd, n_out))


def k11_weights(p, dtype) -> tuple[torch.Tensor, ...]:
    """What ``_final_heads_lowres_pallas`` takes: K11's (wc, bias4, wh_bd,
    bh4), folded in f32 and cast to bf16 once, contiguous; then the head
    matrix and bias in ``dtype`` for the border ring. wh_bd is
    block-diagonal by construction (``_block_diag_heads``), which K11's
    kernel requires, so its callers need not check it on the device."""
    wc, bias4, wcat, bcat = _lowres_head_weights(p, p["final_conv"], dtype)
    wh_bd, bh4 = _block_diag_heads(wcat, bcat)
    k11 = tuple(t.to(torch.bfloat16).contiguous() for t in (wc, bias4, wh_bd, bh4))
    return k11 + (wcat, bcat)


def _final_heads_lowres_pallas(p, x, dtype, exact_gelu: bool, weights):
    """``_final_heads_lowres`` through K11: (B, H, W, cin) → (B, 2H, 2W,
    n_out) f32. ``weights``: ``k11_weights(p, dtype)``, folded once by the
    caller."""
    wc, bias4, wh_bd, bh4, wcat, bcat = weights
    z = composite_final_heads(x, wc, bias4, wh_bd, bh4, exact_gelu=exact_gelu,
                              block_diagonal=True)
    # f32 before the border fix: the ring comes out in dtype, the kernel in bf16
    out = _parity_to_fullres(z, wcat.shape[-1]).float()
    return _exact_border_heads(out, p["final_conv"], x, wcat, bcat, dtype, exact_gelu)


def _final_heads_lowres(p, x, dtype, exact_gelu: bool = False):
    """Composite conv + GELU + heads in the low-res parity domain, then
    depth-to-space and the exact border: (B, H, W, cin) → (B, 2H, 2W,
    n_out) f32. The (2H, 2W, cout) activation is never built."""
    p_final = p["final_conv"]
    wc, bias4, wcat, bcat = _lowres_head_weights(p, p_final, dtype)
    b, h, wd, _ = x.shape
    cout, n_out = wcat.shape
    y = gelu(_conv({"kernel": wc, "bias": bias4}, x, 1, dtype), exact_gelu)
    z = y.reshape(b, h, wd, 4, cout).to(dtype) @ wcat + bcat
    out = _parity_to_fullres(z.reshape(b, h, wd, 4 * n_out), n_out)
    return _exact_border_heads(out, p_final, x, wcat, bcat, dtype, exact_gelu).float()
