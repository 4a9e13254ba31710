"""K10's and K11's wide head route on the CPU.

``HeadTiling`` is the launch geometry of ``csrc/final_heads_wide.cu`` (the
launcher refuses any other), ``head_weight_layout`` and ``head_vectors`` the
layouts the kernel reads. The kernel cannot run here, so these tests hold
what it is built on: the persistent blocks' tiles cover every output pixel
once per phase and the k-slices every (tap, input channel) once per N
chunk; the route is chosen statically (the 64-channel kernels where they
take the shape, the wide route up to ``HEAD_COLS_MAX`` head columns summed
at once, K7's any route past it); and a replay of the kernel's order in
torch (halos built from the tiling's windows, k-slices read from the laid
out weight, N chunks, GELU rounded to bf16, the head's partial sums
accumulated in f32 chunk by chunk) reassembles ``final_heads_plain`` and
``composite_final_heads_plain`` (f32 before the logits' rounding within atol
5e-4 / rtol 1e-3, as ``tests/test_hovernext_parity.py``; the bf16 logits
within chip_smoke.py's bar).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from path_gene_multimodal_tpu_torch.ops import decoder as dec
from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu_kernel

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

_BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _geo(kind: str, b: int, h: int, w: int, cin: int, cout: int, n: int, n_sm: int = 132):
    """The wide route's geometry of K10 (x at (h, w), half resolution),
    K11 stated block-diagonal, or K11 with a full head, as the wrappers
    build it."""
    if kind == "k10":
        return dec.UpsampleTiling(b, h, w, head=True, cin=cin, cout=cout, n_out=n,
                                  n_sm=n_sm).head_geo
    return dec.StripTiling(b, h, w, phases=4, cin=cin, cout=cout, n_out=n, n_sm=n_sm,
                           block_diagonal=kind == "k11_bd").head_geo


# (kind, B, H, W of x, cin, cout, head columns per phase): model (b)'s
# widths, the sweep's wider ones (two K chunks, two N chunks, slices
# streamed), cin != cout with channels no multiple of 8, ragged tiles
GEOS = [("k10", 2, 8, 16, 40, 40, 17), ("k10", 2, 8, 37, 96, 96, 33),
        ("k10", 1, 6, 10, 20, 72, 10), ("k11_bd", 2, 9, 7, 40, 40, 17),
        ("k11_bd", 1, 13, 70, 256, 256, 33), ("k11_full", 2, 9, 7, 40, 40, 17),
        ("k11_full", 1, 5, 66, 96, 96, 20)]


@pytest.mark.parametrize("n_sm", [132, 4])
@pytest.mark.parametrize("shape", GEOS, ids=lambda s: "-".join(map(str, s)))
def test_tiles_cover_every_pixel_once_and_slices_every_tap_and_channel(shape, n_sm):
    kind, b, h, w, cin, cout, n = shape
    geo = _geo(kind, b, h, w, cin, cout, n, n_sm)
    assert geo.fits and geo.smem_bytes <= dec.SMEM_PER_BLOCK
    assert geo.grid % geo.phases == 0 and 0 < geo.grid // geo.phases <= geo.n_tiles
    seen = torch.zeros(geo.phases, b, geo.h, geo.w, dtype=torch.int32)
    for block in range(geo.grid):
        phase, tiles = geo.block_tiles(block)
        for t in tiles:
            img, y0, x0 = geo.tile(t)
            seen[phase, img, y0 : y0 + geo.tile_h, x0 : x0 + geo.tile_w] += 1
        # the inputs the block copies: a tile's K chunks, in its order
        items = geo.items(block)
        per = 1 if len(geo.k_chunks) == 1 else len(geo.n_chunks) * len(geo.k_chunks)
        assert [t for t, _ in items[::per]] == tiles
        assert [k for _, k in items[:per]] == list(range(len(geo.k_chunks))) * (
            per // len(geo.k_chunks))
    assert (seen == 1).all()
    # K chunks split the padded cin in 16-channel steps, N chunks the padded cout
    assert sum(k for _, k in geo.k_chunks) == geo.cin_p >= cin
    assert all(k % 16 == 0 and 0 < k <= geo.k_max for _, k in geo.k_chunks)
    assert sum(nw for _, nw in geo.n_chunks) == geo.cout_p >= geo.cout
    assert all(nw in (16, 32, 48, 64) for _, nw in geo.n_chunks)
    # per N chunk, its slices reduce every (tap, input channel) once
    order = geo.slice_order()
    assert len(order) == geo.slices
    for j in range(len(geo.n_chunks)):
        hits = torch.zeros(9, geo.cin_p, dtype=torch.int32)
        for jj, c in order:
            if jj == j:
                hits[:, 16 * c : 16 * c + 16] += 1
        assert (hits == 1).all()
    # the halo and the window cover a tile's taps (and, K10, their bilinear taps)
    assert geo.halo_shape == (geo.tile_h + 2, geo.tile_w + 2)
    assert geo.window_shape == (geo.tile_h // 2 + 2, geo.tile_w // 2 + 2)
    ring = geo.ring
    assert (ring >= geo.slices) == geo.resident and 2 <= ring <= geo.max_ring or geo.slices == 1
    assert geo.launch_args() == (4, 64, geo.k_chunks[0][1], ring, geo.grid, geo.smem_bytes)


def test_route_is_chosen_by_the_tiling():
    up = lambda c, n: dec.UpsampleTiling(2, 16, 16, head=True, cin=c, cout=c,  # noqa: E731
                                         n_out=n).route
    k11 = lambda c, n, bd=True: dec.StripTiling(2, 16, 16, phases=4, cin=c,  # noqa: E731
                                                cout=c, n_out=n, block_diagonal=bd).route
    assert up(64, 16) == "upsample_conv" and k11(64, 16) == "conv64"
    assert [up(64, 17), up(40, 10), up(40, 17), up(96, 33), up(256, 33)] == ["wide"] * 5
    assert [k11(64, 17), k11(40, 17), k11(256, 33), k11(64, 10, False)] == ["wide"] * 4
    cap = dec.HEAD_COLS_MAX
    assert (up(40, cap), up(40, cap + 1)) == ("wide", "any")
    assert (k11(40, cap), k11(40, cap + 1)) == ("wide", "any")
    assert (k11(40, cap // 4, False), k11(40, cap // 4 + 1, False)) == ("wide", "any")
    assert k11(96, 33, False) == "any"  # 132 columns summed at once
    # K8 and K9 take it too, with no head
    assert dec.UpsampleTiling(2, 16, 16, cin=40, cout=40).route == "wide"
    assert dec.StripTiling(2, 32, 32, cin=40, cout=40).route == "wide"
    # the wide route's geometry: K10 upsamples, a block-diagonal K11 has four
    # phases of (cout, n_out), a full one one phase of (4 cout, 4 n_out)
    g = dec.UpsampleTiling(2, 16, 16, head=True, cin=40, cout=40, n_out=17)
    assert (g.head_geo.upsample, g.head_geo.h, g.head_geo.phases) == (True, 32, 1)
    assert g.smem_bytes == g.head_geo.smem_bytes
    bd, full = (dec.StripTiling(2, 9, 7, phases=4, cin=40, cout=40, n_out=17,
                                block_diagonal=k).head_geo for k in (True, False))
    assert (bd.phases, bd.cout, bd.n_out) == (4, 40, 17)
    assert (full.phases, full.cout, full.n_out) == (1, 160, 68)


def _bf(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(_BF)


def _up_taps(o: torch.Tensor, n: int):
    """conv64::up_taps on a tensor of output coordinates."""
    i, odd = o // 2, o % 2 == 1
    i0 = torch.where(odd, i, (i - 1).clamp(min=0))
    i1 = torch.where(odd, (i + 1).clamp(max=n - 1), i)
    a0 = torch.where(odd, 0.75, 0.25)
    return i0, i1, a0, 1.0 - a0


def _halo(geo, x: torch.Tensor, img: int, oy0: int, ox0: int, c0: int, kw: int) -> torch.Tensor:
    """A tile's halo of channels c0 .. c0 + kw as the kernel builds it, f32
    of bf16 values: K11 the input (zero outside); K10 the bilinear 2x of the
    tile's window, each product and sum in f32, rows first, rounded once."""
    in_h, in_w = geo.in_hw
    hh, hw = geo.halo_shape
    cin = x.shape[-1]

    def box(y0, x0, rows, cols):  # x's pixels, zero outside the image and past cin
        out = torch.zeros(rows, cols, kw)
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + rows, in_h), min(x0 + cols, in_w)
        ce = min(c0 + kw, cin)
        if ye > ys and xe > xs and ce > c0:
            out[ys - y0 : ye - y0, xs - x0 : xe - x0, : ce - c0] = (
                x[img, ys:ye, xs:xe, c0:ce].float())
        return out

    if not geo.upsample:
        return box(oy0 - 1, ox0 - 1, hh, hw)
    wy0, wx0 = geo.window_origin(oy0 // geo.tile_h, ox0 // geo.tile_w)
    win = box(wy0, wx0, *geo.window_shape)
    oy, ox = torch.arange(oy0 - 1, oy0 - 1 + hh), torch.arange(ox0 - 1, ox0 - 1 + hw)
    r0, r1, ra, rb = _up_taps(oy.clamp(0, geo.h - 1), in_h)
    q0, q1, qa, qb = _up_taps(ox.clamp(0, geo.w - 1), in_w)
    r0, r1, q0, q1 = r0 - wy0, r1 - wy0, q0 - wx0, q1 - wx0
    assert min(r0.min(), q0.min()) >= 0 and r1.max() < win.shape[0] and q1.max() < win.shape[1]
    ra, rb, qa, qb = ra[:, None, None], rb[:, None, None], qa[None, :, None], qb[None, :, None]
    u0 = ra * win[r0][:, q0] + rb * win[r1][:, q0]
    u1 = ra * win[r0][:, q1] + rb * win[r1][:, q1]
    halo = (qa * u0 + qb * u1).to(_BF).float()
    inside = ((oy >= 0) & (oy < geo.h))[:, None] & ((ox >= 0) & (ox < geo.w))[None, :]
    return halo * inside[..., None]


def _replay(geo, x, w, b, wh, bh, exact_gelu=False, acc=torch.float32) -> torch.Tensor:
    """The wide head kernel's order, block by block and tile by tile: per N
    chunk its conv over the K chunks' halos and its k-slices read from
    ``head_weight_layout`` (summed in ``acc``, then f32), bias + GELU
    rounded to bf16, times its head rows (``head_vectors``) into f32 sums
    kept across the chunks; then the head bias. f32 logits (before their
    rounding) at each phase's columns."""
    wl = dec.head_weight_layout(w, geo)
    bias, head, hb = dec.head_vectors(b, wh, bh, geo)
    out = torch.full((geo.batch, geo.h, geo.w, geo.phases * geo.n_out), float("nan"))
    th, tw = geo.tile_h, geo.tile_w
    for block in range(geo.grid):
        phase, tiles = geo.block_tiles(block)
        items = iter(geo.items(block))
        for t in tiles:
            img, oy0, ox0 = geo.tile(t)
            z = torch.zeros(th, tw, geo.cols_p)
            halo = None
            for j, (n0, nw) in enumerate(geo.n_chunks):
                sums = torch.zeros(th, tw, nw, dtype=acc)
                for k, (c0, kw) in enumerate(geo.k_chunks):
                    if j == 0 or len(geo.k_chunks) > 1:  # the block's next input item
                        assert next(items) == (t, k)
                        halo = _halo(geo, x, img, oy0, ox0, c0, kw)
                    for c in range(kw // 16):
                        off = geo.slice_offset(j, c0 // 16 + c)
                        sl = (wl[phase, off : off + 144 * nw].reshape(9, 2, nw, 8)
                              .permute(0, 1, 3, 2).reshape(9, 16, nw).to(acc))
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            a_op = halo[dy : dy + th, dx : dx + tw, 16 * c : 16 * c + 16]
                            sums += a_op.to(acc) @ sl[tap]
                y = gelu_kernel(sums.float() + bias[phase, n0 : n0 + nw], exact_gelu)
                y = y.to(_BF).float()
                z += y @ head[phase, n0 : n0 + nw, : geo.cols_p].float()
            logits = (z + hb[phase])[..., : geo.n_out]
            rows, cols = min(th, geo.h - oy0), min(tw, geo.w - ox0)
            out[img, oy0 : oy0 + rows, ox0 : ox0 + cols,
                phase * geo.n_out : (phase + 1) * geo.n_out] = logits[:rows, :cols]
    return out


def _plain_f32(kind, x, w, b, wh, bh, exact_gelu=False) -> torch.Tensor:
    """``final_heads_plain`` / ``composite_final_heads_plain`` before the
    logits' rounding to bf16, the conv summed in f64 and rounded to f32
    (so that no GELU output's bf16 rounding hangs on the order of the
    conv's f32 sums)."""
    f = dec._f
    xin = dec.upsample2x_bilinear(x.to(_BF)).float() if kind == "k10" else f(x)
    y = gelu_kernel(dec._conv3x3(xin.double(), f(w).double()).float() + f(b), exact_gelu)
    return f(y) @ f(wh) + f(bh)


# (kind, x's shape, cin, cout, head columns per phase)
REPLAYS = [("k10", (2, 8, 14), 40, 40, 17), ("k10", (1, 8, 10), 96, 96, 33),
           ("k10", (1, 6, 10), 20, 72, 10), ("k11_bd", (2, 9, 7), 40, 40, 17),
           ("k11_bd", (1, 9, 12), 96, 96, 33), ("k11_full", (2, 9, 7), 40, 40, 17),
           ("k11_full", (1, 9, 12), 96, 96, 20)]


@pytest.mark.parametrize("exact_gelu", [False, True], ids=["tanh", "erf"])
@pytest.mark.parametrize("case", REPLAYS, ids=lambda s: f"{s[0]}-{s[2]}-{s[3]}-{s[4]}")
def test_replay_reassembles_the_plain_versions(case, exact_gelu):
    kind, (b, h, w), cin, cout, n = case
    rng = np.random.default_rng([cin, cout, n, int(exact_gelu), len(kind)])
    x = _bf(rng, (b, h, w, cin))
    bias = _bf(rng, cout if kind == "k10" else 4 * cout, 0.1)
    if kind == "k10":
        wt = _bf(rng, (3, 3, cin, cout), (9 * cin) ** -0.5)
        wh, bh = _bf(rng, (cout, n), 0.3), _bf(rng, n, 0.1)
        plain = dec.final_heads_plain(x, wt, bias, wh, bh, exact_gelu)
        geo = dec.UpsampleTiling(b, h, w, head=True, cin=cin, cout=cout, n_out=n)
    else:
        wt = _bf(rng, (3, 3, cin, 4 * cout), (9 * cin) ** -0.5)
        bh = _bf(rng, 4 * n, 0.1)
        if kind == "k11_bd":
            wh = torch.block_diag(*[_bf(rng, (cout, n), 0.3) for _ in range(4)])
        else:
            wh = _bf(rng, (4 * cout, 4 * n), 0.1)
        plain = dec.composite_final_heads_plain(x, wt, bias, wh, bh, exact_gelu)
        geo = dec.StripTiling(b, h, w, phases=4, cin=cin, cout=cout, n_out=n,
                              block_diagonal=kind == "k11_bd")
    assert geo.route == "wide"
    # the replay's order against the plain math, both convs summed in f64
    got = _replay(geo.head_geo, x, wt, bias, wh, bh, exact_gelu, acc=torch.float64)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, _plain_f32(kind, x, wt, bias, wh, bh, exact_gelu),
                               atol=5e-4, rtol=1e-3)
    # with the kernel's f32 sums, the plain version's logits within
    # chip_smoke.py's bar for heads (a GELU output's rounding may flip)
    got = _replay(geo.head_geo, x, wt, bias, wh, bh, exact_gelu).to(_BF)
    y = (dec.upsample_final_plain(x, wt, bias, exact_gelu) if kind == "k10"
         else dec.final_conv_gelu_plain(x, wt, bias, exact_gelu))
    assert chip_smoke._excess(got, plain, chip_smoke._head_atol(y, wh)) <= 1.0


def test_a_dropped_n_chunk_or_a_phase_on_the_next_block_shows():
    """The replay's bar catches the two faults chip_smoke.py's mutants
    stand for: an N chunk left out of the head's sums, and K11's phase p
    multiplied by diagonal block p + 1."""
    rng = np.random.default_rng(96)
    c, n = 96, 33
    x = _bf(rng, (1, 9, 12, c))
    wc, b4 = _bf(rng, (3, 3, c, 4 * c), (9 * c) ** -0.5), _bf(rng, 4 * c, 0.1)
    whb = torch.block_diag(*[_bf(rng, (c, n), 0.3) for _ in range(4)])
    bh4 = _bf(rng, 4 * n, 0.1)
    ref = dec.composite_final_heads_plain(x, wc, b4, whb, bh4)
    geo = dec.StripTiling(1, 9, 12, phases=4, cin=c, cout=c, n_out=n).head_geo
    assert len(geo.n_chunks) == 2
    for bad in (chip_smoke._dropped_n_chunk(x, wc, b4, whb, bh4, geo),
                dec.composite_final_heads_by_phase(x, wc, b4, whb, bh4, head_of=(1, 2, 3, 0))):
        assert chip_smoke._excess(bad, ref, chip_smoke.DEC_ATOL) > 1.0


def test_weight_and_head_layouts_hold_each_phase_block():
    """head_weight_layout puts slice (N chunk j, step c) of phase p at
    slice_offset(j, c) as [tap][half][column][8]; head_vectors keeps each
    phase's diagonal head block, zero past cout and n_out."""
    rng = np.random.default_rng(7)
    c, n, cin = 40, 17, 24
    geo = dec.StripTiling(1, 9, 7, phases=4, cin=cin, cout=c, n_out=n).head_geo
    wc = _bf(rng, (3, 3, cin, 4 * c))
    wl = dec.head_weight_layout(wc, geo)
    assert wl.shape == (4, geo.cout_p * geo.cin_p * 9)
    for p in range(4):
        for j, (n0, nw) in enumerate(geo.n_chunks):
            for s in range(geo.cin_p // 16):
                off = geo.slice_offset(j, s)
                got = wl[p, off : off + 144 * nw].reshape(3, 3, 2, nw, 8).permute(0, 1, 2, 4, 3)
                want = torch.zeros(3, 3, 16, nw, dtype=_BF)
                ci = slice(16 * s, min(16 * s + 16, cin))
                cols = slice(n0, min(n0 + nw, c))
                width = cols.stop - cols.start
                col = p * c + n0
                want[:, :, : ci.stop - ci.start, :width] = wc[:, :, ci, col : col + width]
                assert torch.equal(got.reshape(3, 3, 16, nw), want)
    whb = torch.block_diag(*[_bf(rng, (c, n)) for _ in range(4)])
    whb[: c, n:] = 7.0  # off the diagonal: never read
    bias, head, hb = dec.head_vectors(_bf(rng, 4 * c), whb, _bf(rng, 4 * n), geo)
    assert head.shape == (4, geo.cout_p, geo.cols_p + 8) and bias.shape == (4, geo.cout_p)
    for p in range(4):
        assert torch.equal(head[p, :c, :n], whb[p * c : (p + 1) * c, p * n : (p + 1) * n])
    assert not head[:, c:].any() and not head[:, :, n:].any() and not hb[:, n:].any()
