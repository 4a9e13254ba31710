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


@pytest.mark.parametrize("bad", [(64, 0, 128), (48, 0, 64), (64, 40, 64), (0, 0, 64)])
def test_geometry_refuses_what_the_kernel_does_not_take(bad):
    cx, cs, cout = bad
    with pytest.raises(ValueError, match="decoder_conv kernel takes"):
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


def _replay(geo, x, skip, w, b, ln_scale, ln_bias, exact):
    """The kernel's schedule in torch, f32 on bf16 values: per block and
    tile, per chunk its zero-padded halo from x or the skip, per slice and
    tap the products of each warpgroup's 8 x 8 blocks with the slice's
    weight rows (read from the kernel's layout), then bias, the LayerNorm
    from per-warpgroup partial sums, GELU, bf16."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    bsz, h, wd, _ = x.shape
    out = torch.full((bsz, h, wd, geo.cout), float("nan"))
    th, tw = geo.tile_h, geo.tile_w
    pad = lambda t: torch.nn.functional.pad(f(t), (0, 0, 1, tw + 1, 1, th + 1))  # noqa: E731
    srcs = [pad(x)] + ([pad(skip)] if skip is not None else [])
    wl = f(k7_weight_layout(w))
    for blk in range(geo.grid):
        for t, writes in geo.block_tiles(blk):
            img, y0, x0 = geo.tile(t)
            acc = torch.zeros(th, tw, geo.cout)
            for chunk, src, c0, _, taps in geo.k_slices():
                halo = srcs[src][img, y0 : y0 + th + 2, x0 : x0 + tw + 2, c0 : c0 + 32]
                for tap in taps:
                    dy, dx = divmod(tap, 3)
                    wk = wl[chunk, tap].permute(0, 2, 1).reshape(32, geo.cout)
                    for grp in range(2):
                        for by, bx, n0 in geo.warpgroup_blocks(grp):
                            a = halo[by * 8 + dy : by * 8 + dy + 8, bx * 8 + dx : bx * 8 + dx + 8]
                            n1 = n0 + geo.n_width
                            acc[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8, n0:n1] += (
                                a @ wk[:, n0:n1])
            acc = acc + f(b)
            if ln_scale is not None:
                acc = _layer_norm_split(acc, f(ln_scale), f(ln_bias), geo.split)
            y = gelu_kernel(acc, exact).to(torch.bfloat16).float()
            if writes:
                hh, ww = min(th, h - y0), min(tw, wd - x0)
                out[img, y0 : y0 + hh, x0 : x0 + ww] = y[:hh, :ww]
    return out


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
