"""K7's launch geometry and weight layout, on the CPU.

``DecoderConvTiling`` is the geometry of ``csrc/decoder_conv.cu`` (the
launcher refuses any other) and ``k7_weight_layout`` the layout in which the
kernel reads the weight. The kernel cannot run here, so these tests hold the
model it is built on: the persistent blocks' tiles and the warpgroups' 8 x 8
pixel blocks cover every output pixel and channel once; the weight slices
reduce every (source, tap, input channel) once per tile, the skip's rows at
offset cx; every block of a cluster receives the whole of each multicast
slice; shared memory stays within a block's; a replay of the schedule in
torch (halo chunks, per-slice products, split LayerNorm, GELU) reassembles
``decoder_conv_plain``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from path_gene_multimodal_tpu_torch.ops import decoder as dec
from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu_kernel
from path_gene_multimodal_tpu_torch.ops.decoder import (
    SMEM_PER_BLOCK,
    DecoderConvTiling,
    k7_weight_layout,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# (B, H, W, cx, cs, cout): the 8 calls of a forward at a 256-px input
# (batch cut to 1-2), then ragged ones (H or W no multiple of the tile)
CALLS = [(2, 16, 16, 768, 384, 384), (1, 16, 16, 384, 0, 384), (2, 32, 32, 384, 192, 192),
         (1, 32, 32, 192, 0, 192), (2, 64, 64, 192, 96, 96), (1, 64, 64, 96, 0, 96),
         (1, 128, 128, 96, 0, 64), (2, 128, 128, 64, 0, 64)]
RAGGED = [(3, 20, 20, 192, 96, 96), (2, 12, 40, 64, 0, 64), (1, 20, 20, 96, 0, 384),
          (2, 12, 40, 32, 32, 192), (1, 9, 13, 32, 0, 64), (2, 7, 33, 64, 64, 384)]
SLOTS = [132, 8]  # a full card, and few blocks (each walks many groups)


def _ids(s):
    return "x".join(map(str, s))


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("shape", CALLS + RAGGED, ids=_ids)
def test_output_covered_once(shape, slots):
    b, h, w, cx, cs, cout = shape
    geo = DecoderConvTiling(b, h, w, cx, cs, cout, slots=slots)
    assert geo.grid % geo.cluster == 0 and 0 < geo.grid <= max(slots, geo.cluster)
    seen = torch.zeros(b, h, w, cout, dtype=torch.int32)
    written = []
    for blk in range(geo.grid):
        for t, writes in geo.block_tiles(blk):
            if not writes:
                continue
            written.append(t)
            img, y0, x0 = geo.tile(t)
            for grp in range(2):
                for by, bx, n0 in geo.warpgroup_blocks(grp):
                    ys, xs = y0 + by * 8, x0 + bx * 8
                    seen[img, ys : ys + 8, xs : xs + 8, n0 : n0 + geo.n_width] += 1
    assert bool((seen == 1).all())
    assert sorted(written) == list(range(geo.n_tiles))
    # the blocks of a cluster walk the same groups: they share every slice
    for k in range(geo.grid // geo.cluster):
        walks = [geo.block_tiles(k * geo.cluster + r) for r in range(geo.cluster)]
        assert len({len(wk) for wk in walks}) == 1
        for steps in zip(*walks):
            tiles = [t for t, wr in steps if wr]
            assert tiles == sorted(tiles) and len(set(tiles)) == len(tiles)


@pytest.mark.parametrize("shape", CALLS + RAGGED, ids=_ids)
def test_slices_reduce_each_tap_and_channel_once(shape):
    b, h, w, cx, cs, cout = shape
    geo = DecoderConvTiling(b, h, w, cx, cs, cout)
    k = cx + cs
    seen = np.zeros((9, k), np.int32)
    for chunk, src, c0, row0, taps in geo.k_slices():
        assert row0 == chunk * 32
        if src == 0:  # x's channels are the first cx weight rows
            assert row0 == c0 and c0 + 32 <= cx
        else:  # the skip's at offset cx
            assert row0 == cx + c0 and c0 + 32 <= cs
        for tap in taps:
            seen[tap, row0 : row0 + 32] += 1
    assert (seen == 1).all()
    assert len(geo.k_slices()) == (k // 32) * (9 // geo.taps)


@pytest.mark.parametrize("shape", CALLS, ids=_ids)
def test_every_block_of_a_cluster_gets_each_slice(shape):
    geo = DecoderConvTiling(*shape)
    parts = geo.multicast_parts()
    assert len(parts) == geo.cluster
    got = np.zeros(geo.slice_bytes, np.int32)
    for off, n in parts:  # each rank's part lands in every block of the cluster
        assert off % 16 == 0 and n % 16 == 0
        got[off : off + n] += 1
    assert (got == 1).all()
    # pixels that share each slice read from L2: 128 at cout 384, 256 at
    # 192, 512 at 96 and 64
    assert geo.cluster * geo.m_tiles * 64 * 2 // geo.split == {384: 128, 192: 256}.get(
        geo.cout, 512)


@pytest.mark.parametrize("cout", dec.KERNEL_COUTS)
def test_shared_memory_fits_a_block(cout):
    geo = DecoderConvTiling(512, 64, 64, 96, 0, cout)
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert geo.slice_bytes % 128 == 0 and geo.halo_bytes % 128 == 0  # TMA landings
    assert geo.n_width // 2 * geo.m_tiles <= 96  # accumulators: registers a thread
    assert len(geo.launch_args()) == 8


@pytest.mark.parametrize("bad", [(64, 0, 1025), (48, -1, 64), (64, 40, 0), (0, 0, 64)])
def test_geometry_refuses_what_the_kernel_does_not_take(bad):
    """What no route takes: no input or output channel, a negative skip
    (the message names the kernel). A cout past 1024, refused until the
    any route took every width, runs there in 384-column chunks."""
    cx, cs, cout = bad
    if cout > 1024:
        geo = DecoderConvTiling(1, 16, 16, cx, cs, cout)
        assert (geo.route, geo.n_tile, geo.n_chunks, geo.raw) == ("any", 384, 3, True)
        return
    with pytest.raises(ValueError, match="decoder_conv kernel takes.*cout >= 1"):
        DecoderConvTiling(1, 16, 16, cx, cs, cout)


def test_weight_layout():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(3, 3, 96, 64)).astype(np.float32))
    wl = k7_weight_layout(w)
    assert wl.shape == (3, 9, 4, 64, 8) and wl.is_contiguous()
    for c, tap, p, co, k in [(0, 0, 0, 0, 0), (2, 8, 3, 63, 7), (1, 4, 2, 17, 5)]:
        assert wl[c, tap, p, co, k] == w[tap // 3, tap % 3, 32 * c + 8 * p + k, co]


def _layer_norm_split(acc, scale, bias, parts):
    """The kernel's LayerNorm over cout split into ``parts`` column blocks
    (one per warpgroup): per-part sums combined into the mean, then
    per-part centred sums of squares combined into the variance."""
    cout = acc.shape[-1]
    halves = acc.chunk(parts, -1)
    mu = sum(hv.sum(-1, keepdim=True) for hv in halves) / cout
    var = sum((hv - mu).square().sum(-1, keepdim=True) for hv in halves) / cout
    return (acc - mu) * torch.rsqrt(var + 1e-6) * scale + bias


@pytest.mark.parametrize("parts", [1, 2])
def test_split_layernorm_equals_unsplit(parts):
    rng = np.random.default_rng(5 + parts)
    acc = torch.from_numpy(rng.normal(loc=0.3, size=(7, 384)).astype(np.float32))
    g = torch.from_numpy(1 + 0.1 * rng.normal(size=384).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.normal(size=384).astype(np.float32))
    mu = acc.mean(-1, keepdim=True)
    ref = (acc - mu) * torch.rsqrt((acc - mu).square().mean(-1, keepdim=True) + 1e-6) * g + b
    torch.testing.assert_close(_layer_norm_split(acc, g, b, parts), ref, rtol=1e-5, atol=1e-5)


def _replay(geo, x, skip, w, b, ln_scale, ln_bias, exact, head=None):
    """The kernel's schedule in torch, f32 on bf16 values: per block and
    tile, per chunk its zero-padded halo from x or the skip (the any
    route: each source zero-padded to whole 32-channel chunks, x
    upsampled first where ``geo.upsample``), per column chunk, slice and
    tap the products of each warpgroup's 8 x 8 blocks with the slice's
    weight rows (read from the kernel's layout), then bias and either the
    LayerNorm from per-warpgroup partial sums over the true cout, GELU,
    bf16, or (``geo.raw``) the f32 sums, which the second pass finishes:
    LayerNorm, GELU, bf16 and ``head`` (wh, bh)."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    th, tw = geo.tile_h, geo.tile_w
    any_route = geo.route == "any"
    wide = geo.n_chunks * geo.n_tile

    def pad(t):
        c = t.shape[-1]
        cp = -(-c // 32) * 32 if any_route else c
        return torch.nn.functional.pad(f(t), (0, cp - c, 1, tw + 1, 1, th + 1))

    if geo.upsample:
        x = dec.upsample2x_bilinear(x.to(torch.bfloat16))
    bsz, h, wd, _ = x.shape
    srcs = [pad(x)] + ([pad(skip)] if skip is not None else [])
    if any_route:
        wl = f(dec.k7_weight_layout_any(w, geo))
        bias = torch.zeros(wide)
        bias[: geo.cout] = f(b)
    else:
        wl, bias = f(k7_weight_layout(w))[None], f(b)
    raw = torch.full((bsz, h, wd, wide), float("nan"))
    out = torch.full((bsz, h, wd, geo.cout), float("nan"))
    for blk in range(geo.grid):
        for t, writes in geo.block_tiles(blk):
            img, y0, x0 = geo.tile(t)
            acc = torch.zeros(th, tw, wide)
            for j in range(geo.n_chunks):
                cols = acc[..., j * geo.n_tile : (j + 1) * geo.n_tile]
                for chunk, src, c0, _, taps in geo.k_slices():
                    halo = srcs[src][img, y0 : y0 + th + 2, x0 : x0 + tw + 2, c0 : c0 + 32]
                    for tap in taps:
                        dy, dx = divmod(tap, 3)
                        wk = wl[j, chunk, tap].permute(0, 2, 1).reshape(32, geo.n_tile)
                        for grp in range(2):
                            for by, bx, n0 in geo.warpgroup_blocks(grp):
                                a = halo[by * 8 + dy : by * 8 + dy + 8,
                                         bx * 8 + dx : bx * 8 + dx + 8]
                                n1 = n0 + geo.n_width
                                cols[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8, n0:n1] += (
                                    a @ wk[:, n0:n1])
            acc = acc + bias
            hh, ww = min(th, h - y0), min(tw, wd - x0)
            if geo.raw:
                if writes:
                    raw[img, y0 : y0 + hh, x0 : x0 + ww] = acc[:hh, :ww]
                continue
            acc = acc[..., : geo.cout]  # the columns past cout add nothing, are not stored
            if ln_scale is not None:
                acc = _layer_norm_split(acc, f(ln_scale), f(ln_bias), geo.split)
            y = gelu_kernel(acc, exact).to(torch.bfloat16).float()
            if writes:
                out[img, y0 : y0 + hh, x0 : x0 + ww] = y[:hh, :ww]
    if not geo.raw:
        return out
    acc = raw[..., : geo.cout]
    if ln_scale is not None:
        acc = _layer_norm_split(acc, f(ln_scale), f(ln_bias), 1)
    y = gelu_kernel(acc, exact).to(torch.bfloat16).float()
    if head is None:
        return y
    wh, bh = head
    return (y @ f(wh) + f(bh)).to(torch.bfloat16).float()


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", [(1, 16, 16, 64, 32, 384), (2, 20, 20, 64, 32, 96),
                                   (1, 12, 40, 64, 0, 64), (1, 10, 18, 32, 32, 192)], ids=_ids)
def test_schedule_replay_reassembles_plain(shape, exact):
    b, h, w, cx, cs, cout = shape
    rng = np.random.default_rng(sum(shape) + int(exact))
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)  # noqa: E731
    x = T(rng.normal(size=(b, h, w, cx)))
    skip = T(rng.normal(size=(b, h, w, cs))) if cs else None
    wt = T(rng.normal(scale=(9 * (cx + cs)) ** -0.5, size=(3, 3, cx + cs, cout)))
    bias = T(rng.normal(scale=0.1, size=cout))
    g, lb = T(1 + rng.normal(scale=0.1, size=cout)), T(rng.normal(scale=0.1, size=cout))
    geo = DecoderConvTiling(b, h, w, cx, cs, cout, slots=4 * 4)
    ref = dec.decoder_conv_plain(x, skip, wt, bias, g, lb, exact_gelu=exact).float()
    got = _replay(geo, x, skip, wt, bias, g, lb, exact)
    assert not torch.isnan(got).any()
    # f32 sums in another order can flip the final bf16 rounding
    m, e = torch.frexp(ref)
    ulp = torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))
    assert bool(((got - ref).abs() <= 2 * ulp + 1e-3).all())
    # no LayerNorm
    ref = dec.decoder_conv_plain(x, skip, wt, bias, exact_gelu=exact).float()
    got = _replay(geo, x, skip, wt, bias, None, None, exact)
    m, e = torch.frexp(ref)
    ulp = torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))
    assert bool(((got - ref).abs() <= 2 * ulp + 1e-3).all())


def _assert_2ulp(got, ref, atol=chip_smoke.DEC_ATOL):
    """Within 2 bf16 ulp + atol elementwise, chip_smoke.py's bar."""
    assert not torch.isnan(got).any()
    assert chip_smoke._excess(got, ref, atol) <= 1.0, float((got - ref).abs().max())


def _bf(rng, shape, scale=1.0, loc=0.0):
    return torch.from_numpy((loc + scale * rng.normal(size=shape)).astype(np.float32)).to(
        torch.bfloat16)


# (B, H, W, cx, cs, cout) of the any route: inputs no multiple of 32 (and
# of 8: plain loads), couts between the tile widths, past 384 (two column
# chunks and the second pass)
ANY_SHAPES = [(1, 12, 20, 20, 12, 40), (1, 10, 18, 64, 48, 80), (2, 9, 13, 96, 0, 160),
              (1, 8, 8, 40, 0, 400)]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", ANY_SHAPES, ids=_ids)
def test_any_route_replay_reassembles_plain(shape, exact):
    """The any route's schedule (padded K and N, the LayerNorm over the
    true cout, past 384 columns f32 sums finished by the second pass)
    reassembles ``decoder_conv_plain``; its weight layout puts the skip's
    rows at its own chunk boundary."""
    b, h, w, cx, cs, cout = shape
    rng = np.random.default_rng(sum(shape) + 7 * int(exact))
    x, skip = _bf(rng, (b, h, w, cx)), _bf(rng, (b, h, w, cs)) if cs else None
    wt = _bf(rng, (3, 3, cx + cs, cout), (9 * (cx + cs)) ** -0.5)
    bias, g, lb = _bf(rng, cout, 0.1), _bf(rng, cout, 0.1, 1.0), _bf(rng, cout, 0.1)
    geo = DecoderConvTiling(b, h, w, cx, cs, cout, slots=8)
    assert geo.route == "any" and geo.raw == (cout > 384)
    assert geo.n_tile == min(n for n in dec.KERNEL_COUTS if n >= min(cout, 384))
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    ref = dec.decoder_conv_plain(x, skip, wt, bias, g, lb, exact_gelu=exact).float()
    _assert_2ulp(_replay(geo, x, skip, wt, bias, g, lb, exact), ref)
    wl = dec.k7_weight_layout_any(wt, geo)
    nx = geo.chunks[0]
    assert wl.shape == (geo.n_chunks, sum(geo.chunks), 9, 4, geo.n_tile, 8)
    if cs:  # the skip's first row, first column: chunk nx, tap 0, plane 0, row 0
        assert wl[0, nx, 0, 0, 0, 0] == wt[0, 0, cx, 0]


def test_any_route_modes_and_the_padded_layernorm():
    """Which sources land by TMA (16-B rows) and which the producer warp
    builds; a LayerNorm over the tile's padded columns (the mutant
    chip_smoke.py holds the kernel against) differs from the true one."""
    assert DecoderConvTiling(1, 8, 8, 20, 12, 40).source_modes() == ("plain", "plain")
    assert DecoderConvTiling(1, 8, 8, 64, 48, 80).source_modes() == ("tma", "tma")
    assert DecoderConvTiling(1, 8, 8, 40, 0, 40, upsample=True).source_modes()[0] == "upsample"
    assert DecoderConvTiling(1, 8, 8, 64, 0, 64).route == "fixed"
    assert DecoderConvTiling(1, 8, 8, 64, 0, 64, upsample=True).route == "any"
    rng = np.random.default_rng(9)
    acc = torch.from_numpy(rng.normal(loc=0.5, size=(5, 64)).astype(np.float32))
    acc[:, 40:] = 0  # the padded columns' zero weights and bias
    one = torch.ones(40)
    true = _layer_norm_split(acc[:, :40], one, 0 * one, 1)
    leak = _layer_norm_split(acc, torch.ones(64), torch.zeros(64), 1)[:, :40]
    assert (true - leak).abs().max() > 0.1


@pytest.mark.parametrize("kernel", ["k9", "k10", "k11_full_head"])
def test_final_stage_any_route_replay_reassembles_plain(kernel):
    """K9 and K10 at C = 40 on the any route's upsampled halos, and K11
    with a full (not block-diagonal) head through the second pass,
    reassemble their plain versions. K10 and K11 take the any route past
    the wide route's HEAD_COLS_MAX columns: K10 with 96 head columns, K11
    with a full head of 4 x 24; K9 takes the wide route, and its any-route
    geometry is replayed as K10's upsampled halos are."""
    rng = np.random.default_rng({"k9": 1, "k10": 2, "k11_full_head": 3}[kernel])
    c, n_out = 40, {"k9": 17, "k10": 96, "k11_full_head": 24}[kernel]
    if kernel == "k11_full_head":
        x = _bf(rng, (1, 9, 7, c))
        wc, b4 = _bf(rng, (3, 3, c, 4 * c), (9 * c) ** -0.5), _bf(rng, 4 * c, 0.1)
        wh, bh = _bf(rng, (4 * c, 4 * n_out), 0.1), _bf(rng, 4 * n_out, 0.1)
        geo = dec.StripTiling(1, 9, 7, phases=4, cin=c, cout=c, n_out=n_out,
                              block_diagonal=False)
        assert geo.route == "any" and geo.any_geo.raw
        ref = dec.composite_final_heads_plain(x, wc, b4, wh, bh).float()
        got = _replay(dataclasses.replace(geo.any_geo, slots=8), x, None, wc, b4, None, None,
                      False, head=(wh, bh))
        _assert_2ulp(got, ref,
                     atol=chip_smoke._head_atol(dec.final_conv_gelu_plain(x, wc, b4), wh))
        return
    x = _bf(rng, (1, 6, 10, c))
    w, b = _bf(rng, (3, 3, c, c), (9 * c) ** -0.5), _bf(rng, c, 0.1)
    head = kernel == "k10"
    geo = dec.UpsampleTiling(1, 6, 10, head=head, cin=c, cout=c, n_out=n_out)
    assert geo.route == ("any" if head else "wide") and geo.any_geo.raw == head
    assert max(geo.smem_bytes, geo.any_geo.smem_bytes) <= SMEM_PER_BLOCK
    if head:
        wh, bh = _bf(rng, (c, n_out), 0.3), _bf(rng, n_out, 0.1)
        ref = dec.final_heads_plain(x, w, b, wh, bh).float()
        got = _replay(dataclasses.replace(geo.any_geo, slots=8), x, None, w, b, None, None,
                      False, head=(wh, bh))
        _assert_2ulp(got, ref,
                     atol=chip_smoke._head_atol(dec.upsample_final_plain(x, w, b), wh))
    else:
        ref = dec.upsample_final_plain(x, w, b).float()
        _assert_2ulp(_replay(dataclasses.replace(geo.any_geo, slots=8), x, None, w, b, None,
                             None, False), ref)


@pytest.mark.parametrize("mutant", ["padded_channel_in_layernorm", "dropped_head_chunk"])
def test_new_width_mutants_cross_the_bar(mutant):
    """The mutants chip_smoke.py holds the any route against at the new
    widths fail its bar against the plain version: the LayerNorm's
    statistics over cout 40 and the 24 zero columns of the 64-wide tile,
    and a 33-column head whose second 16-column chunk is dropped."""
    rng = np.random.default_rng(11)
    if mutant == "padded_channel_in_layernorm":
        x, skip = _bf(rng, (2, 12, 20, 20)), _bf(rng, (2, 12, 20, 12))
        w = _bf(rng, (3, 3, 32, 40), (9 * 32) ** -0.5)
        b, g, lb = _bf(rng, 40, 0.1), _bf(rng, 40, 0.1, 1.0), _bf(rng, 40, 0.1)
        ref = dec.decoder_conv_plain(x, skip, w, b, g, lb)
        bad = chip_smoke._k7_mutant(x, skip, w, b, g, lb, ln_width=64)
        atol = chip_smoke.DEC_ATOL
    else:
        x, w, b = _bf(rng, (2, 6, 10, 40)), _bf(rng, (3, 3, 40, 40), (9 * 40) ** -0.5), _bf(
            rng, 40, 0.1)
        wh, bh = _bf(rng, (40, 33), 0.3), _bf(rng, 33, 0.1)
        ref = dec.final_heads_plain(x, w, b, wh, bh)
        bad = chip_smoke._dropped_head_chunk(ref, bh)
        atol = chip_smoke._head_atol(dec.upsample_final_plain(x, w, b), wh)
    assert chip_smoke._excess(ref, ref, atol) == 0.0
    assert chip_smoke._excess(bad, ref, atol) > 1.0


@pytest.mark.parametrize("case", ["layernorm_past_384", "gelu_only", "head_17", "k11_full_head"])
def test_conv_epilogue_plain_finishes_the_raw_sums(case):
    """The any route's second pass, plain (``conv_epilogue_plain``), on the
    f32 conv + bias the kernel leaves in its scratch (a row ``ld`` wide,
    the columns past c never read: filled with junk here) equals the whole
    plain version of the call it finishes, bit for bit."""
    gen = torch.Generator().manual_seed(31)
    rnd = lambda *s, std=1.0: (std * torch.randn(*s, generator=gen)).to(torch.bfloat16)  # noqa: E731
    cin, c, nh, ln = {"layernorm_past_384": (24, 400, 0, True), "gelu_only": (20, 40, 0, False),
                      "head_17": (40, 40, 17, False), "k11_full_head": (40, 160, 68, False)}[case]
    x, w, b = rnd(2, 6, 5, cin), rnd(3, 3, cin, c, std=(9 * cin) ** -0.5), rnd(c, std=0.1)
    lnv = (rnd(c, std=0.1) + 1, rnd(c, std=0.1)) if ln else (None, None)
    head = (rnd(c, nh, std=0.3), rnd(nh, std=0.1)) if nh else (None, None)
    ld = -(-c // 64) * 64 + 64
    raw = torch.full((2, 6, 5, ld), 1e30)
    raw[..., :c] = dec._conv3x3(x.float(), w.float()) + b.float()
    for exact in (False, True):
        got = dec.conv_epilogue_plain(raw, c, exact, lnv, head)
        if nh:
            ref = dec.composite_final_heads_plain(x, w, b, *head, exact_gelu=exact)
        else:
            ref = dec.decoder_conv_plain(x, None, w, b, *lnv, exact_gelu=exact)
        assert got.dtype == torch.bfloat16 and torch.equal(got, ref), case


@pytest.mark.parametrize("wrapper", ["decoder_conv", "final_conv_gelu", "upsample_final",
                                     "final_heads", "composite_final_heads"])
def test_any_route_counts_each_wrapper_apart(wrapper):
    """Each wrapper's any-route launches are counted under its own name
    (``ANY_LAUNCHES[geo.kernel]``, the geometry its tiling hands K7's any
    route), apart from its own kernel's and from the second pass's."""
    geo = {"decoder_conv": dec.DecoderConvTiling(1, 8, 8, 20, 12, 40),
           "final_conv_gelu": dec.StripTiling(1, 32, 32, cin=40, cout=40).any_geo,
           "upsample_final": dec.UpsampleTiling(1, 8, 8, cin=40, cout=40).any_geo,
           "final_heads": dec.UpsampleTiling(1, 8, 8, head=True, cin=40, cout=40,
                                             n_out=17).any_geo,
           "composite_final_heads": dec.StripTiling(1, 8, 8, phases=4, cin=40, cout=40,
                                                    n_out=17).any_geo}[wrapper]
    assert geo.route == "any" and geo.kernel == wrapper
    counts = {id(c) for c in dec.ANY_LAUNCHES.values()} | {id(dec.EPILOGUE_LAUNCHES)}
    assert len(counts) == len(dec.ANY_LAUNCHES) + 1
    assert dec.ANY_LAUNCHES[wrapper] is not getattr(dec, wrapper)
    assert dec.ANY_LAUNCHES[wrapper].launches >= 0
