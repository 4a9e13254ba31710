"""K1 and K2 at every shape their Pallas kernels take, on the CPU.

The card's K1 takes any C from 1 to ``MAX_C`` and its K2 any tile of
fewer than 2**24 pixels. Here the port's plain versions (which the wrappers
run on CPU tensors) are held against the JAX package's Pallas kernels in
interpret mode at the widths and tiles the card's kernels used to refuse:
K1 at C in {8, 40, 80, 100, 416, 768} within the bar of
``tests/test_torch_kernels_ref.py``, K2 on tiles over 65,536 pixels
integer for integer. K1's padded layout (``pad_weights``: the products run
at C rounded up to 32 on zero-padded weights, the LayerNorm and the GRN mean
over the true C) is replayed here and must give the block's output. A
numpy replay of K2's global route (segment walks over rows, then columns,
the dirty rows and columns skipped) gives the plain version's labels and
passes. chip_smoke.py's ``shapes`` phase holds the kernels themselves
against the same plain versions on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops.pallas.cc_sizes import (
    pallas_cc_sizes,
    pallas_cc_sizes_adaptive,
)
from path_gene_multimodal_tpu.ops.pallas.convnext_block import fused_convnext_block
from path_gene_multimodal_tpu_torch.ops import cc_sizes as tcc
from path_gene_multimodal_tpu_torch.ops import convnext_block as k1
from path_gene_multimodal_tpu_torch.ops.components import INF, index_seeds, relax_fixpoint

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _k1_weights(rng, c):
    ws = [
        rng.normal(scale=0.2, size=(7, 7, c)), rng.normal(scale=0.1, size=(c,)),
        1 + rng.normal(scale=0.1, size=(c,)), rng.normal(scale=0.1, size=(c,)),
        rng.normal(scale=c ** -0.5, size=(c, 4 * c)), rng.normal(scale=0.1, size=(4 * c,)),
        rng.normal(scale=0.5, size=(4 * c,)), rng.normal(scale=0.1, size=(4 * c,)),
        rng.normal(scale=(4 * c) ** -0.5, size=(4 * c, c)), rng.normal(scale=0.1, size=(c,)),
    ]
    return [a.astype(np.float32) for a in ws]


@pytest.mark.parametrize("c", [8, 40, 80, 100, 416, 768])
def test_k1_plain_matches_pallas_interpret_at_any_width(c):
    """bf16 block on 2 x 8 x 8 images: max |port - jax| / max |jax| <=
    1e-2, the bar of ``test_k1_plain_matches_pallas_interpret``."""
    rng = np.random.default_rng(1000 + c)
    x = rng.normal(size=(2, 8, 8, c)).astype(np.float32)
    ws = _k1_weights(rng, c)
    ref = np.asarray(fused_convnext_block(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, ws),
                                          interpret=True).astype(jnp.float32))
    got = k1.convnext_block(T(x).to(torch.bfloat16), *map(T, ws)).float().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-2


def _padded_block(x, wts, c):
    """The kernel's arithmetic in its padded layout, in the plain
    version's pieces: a with zeros past C, pw1 at cp on the padded w1 and
    b1, the GRN at cp with its mean over the true 4C, pw2 at cp, the output
    channels below C. Returns (y2 at cp, output)."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    cp = k1.padded_channels(c)
    dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2 = k1.pad_weights(wts, c)
    b, h, w, _ = x.shape
    a = F.pad(k1.dw_ln_plain(x, dw, dwb, lng, lnb), (0, cp - c))
    y2 = k1.pw1_plain(a, w1, b1)
    gx = torch.sqrt(y2.square().sum(1) + 1e-12)[:, None, :]
    mean = (gx[..., : 4 * c].double().sum(-1, keepdim=True) / (4 * c)).float()
    scale = k1._fma(f(gg).expand_as(gx), gx / (mean + 1e-6), torch.ones_like(gx))
    y3 = f(k1._fma(y2, scale.expand_as(y2), f(gb).expand_as(y2)))
    y4 = (y3.reshape(-1, 4 * cp) @ f(w2)).reshape(b, h, w, cp)[..., :c] + f(b2)
    return y2, (f(x) + y4).to(torch.bfloat16)


@pytest.mark.parametrize("c", [1, 40, 100])
def test_padded_weights_keep_the_block(c):
    """``pad_weights`` gives C no multiple of 32 the kernel's layout: y2
    is exactly 0 in the padded channels (GELU(0)), and the padded block
    equals the plain block within 1 bf16 ulp (the products' f32 sums run
    over extra zero terms)."""
    rng = np.random.default_rng(c)
    x = T(rng.normal(size=(2, 5, 7, c)).astype(np.float32)).to(torch.bfloat16)
    wts = [T(a).to(torch.bfloat16) for a in _k1_weights(rng, c)]
    wts[4], wts[8] = wts[4].t().contiguous().t(), wts[8].t().contiguous().t()
    pw = k1.pad_weights(wts, c)
    cp = k1.padded_channels(c)
    assert pw[4].shape == (cp, 4 * cp) and pw[4].t().is_contiguous()
    assert pw[8].shape == (4 * cp, cp) and pw[8].t().is_contiguous()
    assert all(pw[i].shape == (4 * cp,) for i in (5, 6, 7)) and pw[9].shape == (c,)
    y2, out = _padded_block(x, wts, c)
    assert bool((y2[..., 4 * c:] == 0).all())
    ref = k1.convnext_block_plain(x, *wts)
    ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp(min=1e-30))) - 7)
    assert bool(((out.float() - ref.float()).abs() <= ulp + 1e-6).all())
    assert all(a is b for a, b in zip(k1.pad_weights(pw, cp), pw))  # whole chunks: as they are


# ---------------------------------------------------------------- K2


def _blobs(rng, b, h, w, thr=0.55, sigma=2.0):
    f = np.stack([gaussian_filter(rng.random((h, w)), sigma) for _ in range(b)])
    f = (f - f.min(axis=(1, 2), keepdims=True)) / np.ptp(f, axis=(1, 2), keepdims=True)
    return f > thr


def test_k2_plain_matches_pallas_interpret_over_65536_pixels():
    """An 8 x 8200 tile (the global route's): labels, sizes, dense ids and
    root counts integer for integer, at min_size 3, the slots below the
    tile's component count (so some overflow)."""
    mask, slots = _blobs(np.random.default_rng(7), 1, 8, 8200, sigma=1.5), 48
    assert not tcc.CcSizesTiling(*mask.shape[1:], slots).shared
    jl, js, jd = map(np.asarray, pallas_cc_sizes(jnp.asarray(mask), 1, s_slots=slots,
                                                 min_size=3, interpret=True))
    tl, ts, td, tn = tcc.cc_sizes(T(mask), s_slots=slots, min_size=3)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(td.numpy(), jd)
    pix = np.arange(mask.shape[1] * mask.shape[2]).reshape(mask.shape[1:])
    np.testing.assert_array_equal(tn.numpy(), (jl == pix).sum(axis=(1, 2)))
    assert int(tn[0]) > slots


def test_k2_adaptive_matches_pallas_interpret_over_65536_pixels():
    """The adaptive contract on two 8 x 8200 tiles: the re-run at ``big``
    when a tile overflows ``small``, the overflow flags past ``big``."""
    rng = np.random.default_rng(8)
    mask = _blobs(rng, 2, 8, 8200, sigma=1.5)
    mask[1, :, 4000:] = False  # fewer components in the second tile
    n = [int(x) for x in tcc.cc_sizes(T(mask))[3]]
    small, big = 16, (n[0] + n[1]) // 2
    assert n[1] < big < n[0]
    jl, js, jd, jo = map(np.asarray, pallas_cc_sizes_adaptive(
        jnp.asarray(mask), 1, min_size=3, small=small, big=big, interpret=True,
        count_overflow=True))
    tl, ts, td, to = tcc.cc_sizes_adaptive(T(mask), min_size=3, small=small, big=big)
    for got, want in ((tl, jl), (ts, js), (td, jd), (to, jo)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert to.tolist() == [True, False]


def _global_replay(mask, max_iters=256):
    """csrc/cc_sizes.cu's global route on one tile in numpy: per pass the
    row phase, then the column phase, each walking its lines in the
    segments ``CcSizesTiling`` splits them into (forward running minima in
    place and the segments' head/tail/full records, then backward run
    minima joined across segments); after the first pass only the lines
    the other phase changed. Returns (labels, passes)."""
    h, w = mask.shape
    geo = tcc.CcSizesTiling(h, w, 64)
    lbl = np.where(mask, np.arange(h * w).reshape(h, w), INF).astype(np.int64)

    def phase(arr, split, dirty):
        segs, seg_len = split
        n_lines, length = arr.shape
        changed_cross = set()
        for ln in range(n_lines):
            if dirty is not None and ln not in dirty:
                continue
            line = arr[ln]
            rec = []
            for s in range(segs):
                a, b = s * seg_len, min((s + 1) * seg_len, length)
                acc = head = INF
                first_bg = b
                for r in range(a, b):
                    fg = line[r] < INF
                    acc = min(acc, line[r]) if fg else INF
                    if fg and acc != line[r]:
                        line[r] = acc
                        changed_cross.add(r)
                    if not fg and first_bg == b:
                        first_bg = r
                    if first_bg == b:
                        head = acc
                rec.append((head, acc, first_bg == b, first_bg))
            for s in range(segs):
                a, b = s * seg_len, min((s + 1) * seg_len, length)
                top = bottom = INF
                for k in range(s - 1, -1, -1):
                    top = min(top, rec[k][1])
                    if not rec[k][2]:
                        break
                for k in range(s + 1, segs):
                    bottom = min(bottom, rec[k][0])
                    if not rec[k][2]:
                        break
                rm, below = INF, False
                for r in range(b - 1, a - 1, -1):
                    fg = line[r] < INF
                    if fg:
                        if not below:
                            rm = line[r]
                            if r == b - 1:
                                rm = min(rm, bottom)
                            if r < rec[s][3]:
                                rm = min(rm, top)
                        if rm != line[r]:
                            line[r] = rm
                            changed_cross.add(r)
                    below = fg
        return changed_cross

    passes, rows = 0, None
    while True:
        old = lbl.copy()
        cols = phase(lbl, geo.row_split, rows)
        rows = phase(lbl.T, geo.col_split, None if passes == 0 else cols)
        passes += 1
        if (lbl == old).all() or passes >= 1 + max_iters:
            break
    return lbl.astype(np.int32), passes


def _staircase(n):
    m = np.zeros((n, n + 1), bool)
    for i in range(n):
        m[i, i : i + 2] = True
    return m


@pytest.mark.parametrize("name", ["blobs_3x1100", "thin_1030x4", "staircase_60"])
def test_k2_global_replay_matches_plain(name):
    rng = np.random.default_rng(5)
    mask = {"blobs_3x1100": lambda: _blobs(rng, 1, 3, 1100, sigma=1.0)[0],
            "thin_1030x4": lambda: rng.random((1030, 4)) < 0.6,
            "staircase_60": lambda: _staircase(60)}[name]()
    want, n = relax_fixpoint(T(mask[None]), index_seeds(T(mask[None])), 1, tcc.MAX_ITERS)
    replay_max = tcc.MAX_ITERS if name != "staircase_60" else 20  # a cap that binds
    if name == "staircase_60":
        want, n = relax_fixpoint(T(mask[None]), index_seeds(T(mask[None])), 1, replay_max)
    lbl, passes = _global_replay(mask, replay_max)
    np.testing.assert_array_equal(lbl, want[0].numpy())
    assert passes == int(n[0])
