"""K1 on seeded weights at the stage-0 shape (64 x 64 x 96 at the 256-px
input), on the CPU: the port's plain version against the JAX package's
``fused_convnext_block(..., interpret=True)``, with the seeded input and
block weights of ``chip_smoke.py --ab`` (``_block_weights``: GRN and
biases drawn too, so the GRN scales y2 through w2), and the per-launch
checks ``chip_smoke.py`` holds each of the kernel's three launches to.

What they establish: the two agree within the block's bar (2 bf16 ulp +
``K1_ATOL``) on two images, in under 0.2% of the outputs differ, and the
worst element's difference is the sum through w2 of the bf16 roundings of
y3 that differ at its pixel (so a difference in the last bit of y2, from
sums taken in another order or a flipped rounding of the pw1 operand a,
turns into whole bf16 steps of y3); and each per-launch check passes on
the plain chain itself and sees its mutant."""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_gene_multimodal_tpu.ops.pallas.convnext_block import _gelu_fn, fused_convnext_block
from path_gene_multimodal_tpu_torch.models.convnext import Block
from path_gene_multimodal_tpu_torch.ops import convnext_block as k1

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

BF = torch.bfloat16


@partial(jax.jit, static_argnames=("exact",))
def _reference_chain(x, dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2, exact=False):
    """The body of the Pallas kernel (``ops/pallas/convnext_block.py``,
    ``_block_kernel``) as plain XLA ops, returning its rounding points:
    the pw1 operand a (bf16), y3 (bf16) and the output; then the
    LayerNorm's input acc, the f32 y2 and its per-image sums of squares."""
    g, h, w, c = x.shape
    xf = x.astype(jnp.float32)
    xp = jnp.pad(xf, ((0, 0), (3, 3), (3, 3), (0, 0)))
    acc = jnp.zeros_like(xf)
    for dx in range(7):
        xdx = jax.lax.slice(xp, (0, 0, dx, 0), (g, h + 6, dx + w, c))
        for dy in range(7):
            tap = jax.lax.slice(xdx, (0, dy, 0, 0), (g, dy + h, w, c))
            acc = acc + tap * dw[dy, dx, :].astype(jnp.float32)
    acc = acc + dwb.astype(jnp.float32)
    mu = jnp.mean(acc, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(acc - mu), axis=-1, keepdims=True)
    y = (acc - mu) * jax.lax.rsqrt(var + 1e-6)
    y = y * lng.astype(jnp.float32) + lnb.astype(jnp.float32)
    a = y.reshape(g * h * w, c).astype(jnp.bfloat16)
    y2 = jnp.dot(a, w1, preferred_element_type=jnp.float32) + b1.astype(jnp.float32)
    y2 = _gelu_fn(exact)(y2).reshape(g, h * w, 4 * c)
    gsum = jnp.sum(jnp.square(y2), axis=1, keepdims=True)
    gx = jnp.sqrt(gsum + 1e-12)
    nx = gx / (jnp.mean(gx, axis=-1, keepdims=True) + 1e-6)
    y3 = (y2 * (gg.astype(jnp.float32) * nx + 1.0) + gb.astype(jnp.float32)).astype(jnp.bfloat16)
    y4 = jnp.dot(y3.reshape(g * h * w, 4 * c), w2,
                 preferred_element_type=jnp.float32) + b2.astype(jnp.float32)
    out = (xf + y4.reshape(g, h, w, c)).astype(jnp.bfloat16)
    return a.reshape(g, h * w, c), y3, out, acc, y2, gsum[:, 0]


def _seeded(n, hw=64, c=96):
    x = torch.randn((n, hw, hw, c), generator=torch.Generator().manual_seed(900)).to(BF)
    return x, chip_smoke._block_weights(Block, c, 910, "cpu")


@pytest.mark.parametrize("exact_gelu", [True, False])
def test_plain_against_pallas_interpret_on_seeded_weights(exact_gelu):
    x, wts = _seeded(2)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in wts]
    ref = np.array(fused_convnext_block(jx, *jw, exact_gelu=exact_gelu, interpret=True)
                   .astype(jnp.float32))
    a_j, y3_j, out_j = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                        for t in _reference_chain(jx, *jw, exact=exact_gelu)[:3])
    np.testing.assert_array_equal(out_j.numpy(), ref)  # the chain is the kernel's arithmetic
    ref = torch.from_numpy(ref)
    got = k1.convnext_block_plain(x, *wts, exact_gelu=exact_gelu).float()
    excess = chip_smoke._excess(got, ref, chip_smoke.K1_ATOL)
    assert excess <= 1.0, excess
    assert float((got != ref).float().mean()) <= 2e-3

    # the worst element: its difference is that of the pixel's y3 roundings
    ex = (got - ref).abs() / (2 * chip_smoke._bf16_ulp(ref) + chip_smoke.K1_ATOL)
    i, r, col, ch = np.unravel_index(int(ex.argmax()), ex.shape)
    pix = r * x.shape[2] + col
    dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2 = wts
    a_p = k1.dw_ln_plain(x, dw, dwb, lng, lnb).to(BF).float().reshape(a_j.shape)
    y2_p = k1.pw1_plain(a_p, w1, b1, exact_gelu)
    y3_p = k1.grn_plain(y2_p, y2_p.square().sum(1), gg, gb)
    flips = int((y3_p[i, pix] != y3_j[i, pix]).sum())
    predicted = float((y3_p[i, pix] - y3_j[i, pix]) @ w2.float()[:, ch])
    seen = float(got[i, r, col, ch] - ref[i, r, col, ch])
    assert flips >= 1
    assert abs(predicted - seen) <= float(chip_smoke._bf16_ulp(ref[i, r, col, ch])) + 1e-4
    assert int((a_p != a_j).sum()) <= 1e-3 * a_p.numel()  # flipped roundings of a are rare


def test_reference_multiply_adds_are_fused():
    """XLA on the CPU computes ``a * b + c`` in f32 as one fused
    multiply-add (rounded once), as the reference chain's LayerNorm affine
    and GRN steps are written: the plain version's ``_fma`` models it."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(1 << 16).astype(np.float32) for _ in range(3))
    got = np.array(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fused = k1._fma(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    assert np.array_equal(got, fused)
    assert not np.array_equal(got, a * b + c)  # numpy rounds the product first


@pytest.mark.parametrize("c,hw,exact_gelu", [(96, 64, True), (192, 32, False), (384, 16, True)])
def test_plain_ln_and_grn_closer_to_reference(c, hw, exact_gelu):
    """Fed the reference chain's own LayerNorm input, y2 and sums of
    squares, the plain LayerNorm and GRN reproduce the reference's bf16 a
    and y3 bit for bit in at least as many (a) and more (y3) elements than
    their unfused form (the product rounded before the sum, the GRN mean an
    f32 mean), which the plain version had before. (The GRN mean is the
    f64 sum rounded once, not the reference's f32 sum in XLA's order, which
    no other order repeats; an order-free mean lets launch 2's check hold
    the kernel's y3 to the plain one.)"""
    x, wts = _seeded(2, hw, c)
    dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2 = wts
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in wts]
    a_j, y3_j, _, acc, y2, gsum = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                                   for t in _reference_chain(jx, *jw, exact=exact_gelu))
    f = lambda t: t.to(BF).float()  # noqa: E731
    mu = acc.mean(-1, keepdim=True)
    t = (acc - mu) * torch.rsqrt((acc - mu).square().mean(-1, keepdim=True) + 1e-6)
    a_unfused = f(t * f(lng) + f(lnb)).reshape(a_j.shape)
    a_plain = f(k1.layer_norm_plain(acc, lng, lnb)).reshape(a_j.shape)
    gx = torch.sqrt(gsum + 1e-12)[:, None, :]
    y3_unfused = f(y2 * (f(gg) * (gx / (gx.mean(-1, keepdim=True) + 1e-6)) + 1.0) + f(gb))
    y3_plain = k1.grn_plain(y2, gsum, gg, gb)
    a_diffs = int((a_plain != a_j).sum()), int((a_unfused != a_j).sum())
    y3_diffs = int((y3_plain != y3_j).sum()), int((y3_unfused != y3_j).sum())
    assert a_diffs[0] <= a_diffs[1], a_diffs
    assert y3_diffs[0] < y3_diffs[1], y3_diffs
    assert y3_diffs[0] <= 1e-4 * y3_j.numel(), y3_diffs


def test_launch_checks_pass_on_the_plain_chain_and_see_their_mutants(monkeypatch):
    """``chip_smoke._k1_parts_check`` fed the plain version's own launches
    (a, y2, the GRN sums, the output) reads no excess over any bar, and
    each mutant crosses its bar (the fused GRN's on 8 images of 64^2)."""

    def plain_parts(x, wts, exact_gelu):
        dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2 = wts
        b, h, w, c = x.shape
        a = k1.dw_ln_plain(x, dw, dwb, lng, lnb).to(BF).reshape(b, h * w, c)
        y2 = k1.pw1_plain(a, w1, b1, exact_gelu)
        gsum = y2.square().sum(1)
        return a, y2, gsum, k1.pw2_plain(x, y2, gsum, gg, gb, w2, b2)

    monkeypatch.setattr(chip_smoke, "_k1_kernel_parts", plain_parts)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    x, wts = _seeded(8)
    failures = []
    rec = chip_smoke._k1_parts_check("seeded", x, wts, False, failures, see_unfused=True)
    assert failures == []
    for key in ("a_excess", "y2_excess", "out_excess"):
        assert rec[key] == 0.0, key
    assert rec["gsum_excess"] <= 0.05


@pytest.mark.parametrize("c,hw,offset", [(384, 16, 0.0), (192, 16, 5.0), (96, 32, 0.0)])
def test_launch0_bar_holds_between_reference_and_plain(c, hw, offset):
    """The bar the main run holds launch 0's a to (1 bf16 ulp +
    ``_k1_ln_slack``) holds between the reference's a and the plain
    version's, which take their LayerNorm means in other orders, on inputs
    whose pixels' means lie far from zero against their spread (a dw bias
    of 4, per-pixel offsets), where 1 bf16 ulp alone does not hold."""
    g = torch.Generator().manual_seed(c)
    x = (torch.randn((8, hw, hw, c), generator=g)
         + offset * torch.randn((8, hw, hw, 1), generator=g)).to(BF)
    wts = chip_smoke._block_weights(Block, c, 910, "cpu")
    wts[1] = (wts[1].float() + 4.0).to(BF)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in wts]
    a_j = torch.from_numpy(np.array(_reference_chain(jx, *jw)[0].astype(jnp.float32)))
    dw, dwb, lng, lnb = wts[:4]
    a_p = k1.dw_ln_plain(x, dw, dwb, lng, lnb).to(BF).float().reshape(a_j.shape)
    ulp = chip_smoke._bf16_ulp(a_p)
    d = (a_j - a_p).abs()
    assert float((d / (ulp + 1e-30)).max()) > 1.0
    tol = chip_smoke._k1_ln_slack(x, dw, dwb, lng, lnb).reshape(a_j.shape)
    assert float((d / (ulp + tol)).max()) <= 1.0

