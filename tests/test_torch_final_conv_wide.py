"""K8's and K9's wide route (the wide kernel with no head) on the CPU.

``HeadTiling`` with ``n_out`` 0 is the launch geometry of
``csrc/final_heads_wide.cu``'s head-less instantiations (``conv_wide_launch``
refuses any other), ``head_weight_layout`` the weight's layout. The kernel
cannot run here, so these tests hold what it is built on: the persistent
blocks' tiles cover every output pixel once and the k-slices every (tap,
input channel) once per N chunk; the route is chosen statically (the
64-channel kernels at C = 64, the wide route elsewhere, K7's any route for
K8 whose weights would stream); a replay of the kernel's order in torch
(halos built from the tiling's windows, k-slices read from the laid-out
weight, each N chunk's bias + GELU, rounded to bf16, stored at its column
offset) reassembles ``upsample_final_plain`` and ``final_conv_gelu_plain``
(f32 before the rounding within atol 5e-4 / rtol 1e-3, the bf16 output
within chip_smoke.py's bar), every output element stored once; the
mutants chip_smoke.py holds the route against fail that bar; and the plain
versions equal the Pallas kernels (interpret mode) at cin != cout.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_gene_multimodal_tpu.ops.pallas import decoder as jdec
from path_gene_multimodal_tpu_torch.ops import decoder as dec
from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu_kernel

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke  # noqa: E402
from test_torch_decoder import _assert_elementwise  # noqa: E402
from test_torch_final_heads_any import _halo  # noqa: E402

_BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiling(kind: str, b: int, h: int, w: int, cin: int, cout: int, n_sm: int = 132):
    """K9's (x at (h, w), half resolution) or K8's tiling, as the wrapper
    builds it."""
    if kind == "k9":
        return dec.UpsampleTiling(b, h, w, n_sm=n_sm, cin=cin, cout=cout)
    return dec.StripTiling(b, h, w, n_sm=n_sm, cin=cin, cout=cout)


# (kind, B, H, W of x, cin, cout): model (b)'s width, cin != cout with
# channels no multiple of 8, two K chunks and N chunks of 128, ragged tiles
GEOS = [("k9", 2, 8, 16, 40, 40), ("k9", 1, 6, 10, 20, 72), ("k9", 1, 8, 37, 96, 136),
        ("k9", 1, 4, 8, 1152, 1152), ("k8", 2, 32, 70, 40, 40), ("k8", 1, 32, 10, 20, 72),
        ("k8", 1, 32, 24, 16, 136), ("k8", 1, 32, 40, 40, 36)]


@pytest.mark.parametrize("n_sm", [132, 4])
@pytest.mark.parametrize("shape", GEOS, ids=lambda s: "-".join(map(str, s)))
def test_tiles_cover_every_pixel_once_and_slices_every_tap_and_channel(shape, n_sm):
    kind, b, h, w, cin, cout = shape
    geo = _tiling(kind, b, h, w, cin, cout, n_sm).head_geo
    assert not geo.head and geo.fits and geo.smem_bytes <= dec.SMEM_PER_BLOCK
    assert geo.n_max == (128 if cout > 64 else 64) and geo.phases == 1
    assert 0 < geo.grid <= geo.n_tiles
    seen = torch.zeros(b, geo.h, geo.w, dtype=torch.int32)
    for block in range(geo.grid):
        _, tiles = geo.block_tiles(block)
        for t in tiles:
            img, y0, x0 = geo.tile(t)
            seen[img, y0 : y0 + geo.tile_h, x0 : x0 + geo.tile_w] += 1
        items = geo.items(block)
        per = 1 if len(geo.k_chunks) == 1 else len(geo.n_chunks) * len(geo.k_chunks)
        assert [t for t, _ in items[::per]] == tiles
    assert (seen == 1).all()
    assert sum(nw for _, nw in geo.n_chunks) == geo.cout_p >= cout
    assert all(nw % 16 == 0 and 0 < nw <= geo.n_max for _, nw in geo.n_chunks)
    order = geo.slice_order()
    assert len(order) == geo.slices
    for j in range(len(geo.n_chunks)):
        hits = torch.zeros(9, geo.cin_p, dtype=torch.int32)
        for jj, c in order:
            if jj == j:
                hits[:, 16 * c : 16 * c + 16] += 1
        assert (hits == 1).all()
    # the launcher's arguments: n_max after the K chunk width
    assert geo.launch_args() == (4, 64, geo.k_chunks[0][1], geo.n_max, geo.ring, geo.grid,
                                 geo.smem_bytes)


def test_route_is_chosen_by_the_tiling():
    k9 = lambda ci, co: dec.UpsampleTiling(2, 16, 16, cin=ci, cout=co).route  # noqa: E731
    k8 = lambda ci, co: dec.StripTiling(2, 32, 32, cin=ci, cout=co).route  # noqa: E731
    assert (k9(64, 64), k8(64, 64)) == ("upsample_conv", "conv64")
    assert [k9(40, 40), k9(20, 72), k9(96, 136), k9(256, 256), k9(1152, 1152), k9(64, 40),
            k9(40, 64)] == ["wide"] * 7
    # K8 takes the wide route where its weights stay resident, else K7's any route
    assert [k8(40, 40), k8(20, 72), k8(16, 136), k8(40, 64)] == ["wide"] * 4
    assert [k8(96, 96), k8(128, 128), k8(256, 256), k8(1152, 1152), k8(96, 136)] == ["any"] * 5
    for ci, co in ((40, 40), (96, 96), (1152, 1152)):
        geo = dec.StripTiling(2, 32, 32, cin=ci, cout=co).head_geo
        assert (k8(ci, co) == "wide") == geo.resident
    # the geometry: K9 upsamples with no head, N chunks of 64 up to 64 columns
    g = dec.UpsampleTiling(2, 16, 16, cin=40, cout=40)
    assert (g.head_geo.upsample, g.head_geo.h, g.head_geo.n_out, g.head_geo.n_max) == (
        True, 32, 0, 64)
    assert g.smem_bytes == g.head_geo.smem_bytes and g.head_geo.kernel == "upsample_final"
    assert dec.StripTiling(2, 32, 32, cin=20, cout=72).head_geo.kernel == "final_conv_gelu"
    with pytest.raises(ValueError, match="N chunks of 64"):
        dec.HeadTiling(1, 8, 8, 40, 40, 17, n_max=128)


def _replay(geo, x, w, b, exact_gelu=False, acc=torch.float32):
    """The head-less kernel's order, block by block and tile by tile: per N
    chunk its conv over the K chunks' halos and its k-slices read from
    ``head_weight_layout`` (summed in ``acc``), bias + GELU in f32, the
    chunk's valid columns stored at its offset. (f32 output before the
    rounding, the count of stores of each output element.)"""
    wl = dec.head_weight_layout(w, geo)
    bias = torch.zeros(geo.cout_p)
    bias[: geo.cout] = b.float()
    out = torch.full((geo.batch, geo.h, geo.w, geo.cout), float("nan"))
    stores = torch.zeros(out.shape, dtype=torch.int32)
    th, tw = geo.tile_h, geo.tile_w
    for block in range(geo.grid):
        _, tiles = geo.block_tiles(block)
        items = iter(geo.items(block))
        for t in tiles:
            img, oy0, ox0 = geo.tile(t)
            rows, cols = min(th, geo.h - oy0), min(tw, geo.w - ox0)
            halo = None
            for j, (n0, nw) in enumerate(geo.n_chunks):
                sums = torch.zeros(th, tw, nw, dtype=acc)
                for k, (c0, kw) in enumerate(geo.k_chunks):
                    if j == 0 or len(geo.k_chunks) > 1:  # the block's next input item
                        assert next(items) == (t, k)
                        halo = _halo(geo, x, img, oy0, ox0, c0, kw)
                    for c in range(kw // 16):
                        off = geo.slice_offset(j, c0 // 16 + c)
                        sl = (wl[0, off : off + 144 * nw].reshape(9, 2, nw, 8)
                              .permute(0, 1, 3, 2).reshape(9, 16, nw).to(acc))
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            a_op = halo[dy : dy + th, dx : dx + tw, 16 * c : 16 * c + 16]
                            sums += a_op.to(acc) @ sl[tap]
                y = gelu_kernel(sums.float() + bias[n0 : n0 + nw], exact_gelu)
                vc = min(nw, geo.cout - n0)
                out[img, oy0 : oy0 + rows, ox0 : ox0 + cols, n0 : n0 + vc] = y[:rows, :cols, :vc]
                stores[img, oy0 : oy0 + rows, ox0 : ox0 + cols, n0 : n0 + vc] += 1
    return out, stores


def _plain_f32(kind, x, w, b, exact_gelu=False) -> torch.Tensor:
    """``upsample_final_plain`` / ``final_conv_gelu_plain`` before the
    rounding to bf16, the conv summed in f64 and rounded to f32."""
    f = dec._f
    xin = dec.upsample2x_bilinear(x.to(_BF)).float() if kind == "k9" else f(x)
    return gelu_kernel(dec._conv3x3(xin.double(), f(w).double()).float() + f(b), exact_gelu)


def _bf(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(_BF)


# (kind, x's shape, cin, cout): C = 40, 20 -> 72 and 96 -> 136 (two K
# chunks, N chunks of 128 and 16; K8 there takes K7's any route, its
# k-slices streaming, and the wide kernel's order is replayed all the
# same), K8's cout past 80 at cin 16
REPLAYS = [("k9", (2, 6, 14), 40, 40), ("k9", (1, 6, 10), 20, 72), ("k9", (1, 4, 9), 96, 136),
           ("k8", (1, 32, 14), 40, 40), ("k8", (1, 32, 10), 20, 72),
           ("k8", (1, 32, 9), 96, 136), ("k8", (1, 32, 9), 16, 136)]


@pytest.mark.parametrize("exact_gelu", [False, True], ids=["tanh", "erf"])
@pytest.mark.parametrize("case", REPLAYS, ids=lambda s: f"{s[0]}-{s[2]}-{s[3]}")
def test_replay_reassembles_the_plain_versions(case, exact_gelu):
    kind, (b, h, w), cin, cout = case
    rng = np.random.default_rng([cin, cout, int(exact_gelu), len(kind), h])
    x = _bf(rng, (b, h, w, cin))
    wt, bias = _bf(rng, (3, 3, cin, cout), (9 * cin) ** -0.5), _bf(rng, cout, 0.1)
    tiling = _tiling(kind, b, h, w, cin, cout)
    geo = tiling.head_geo
    assert tiling.route == ("any" if kind == "k8" and not geo.resident else "wide")
    got, stores = _replay(geo, x, wt, bias, exact_gelu, acc=torch.float64)
    assert (stores == 1).all()  # every N chunk at its own offset, every element once
    torch.testing.assert_close(got, _plain_f32(kind, x, wt, bias, exact_gelu),
                               atol=5e-4, rtol=1e-3)
    plain = (dec.upsample_final_plain if kind == "k9" else dec.final_conv_gelu_plain)(
        x, wt, bias, exact_gelu)
    got, _ = _replay(geo, x, wt, bias, exact_gelu)
    assert chip_smoke._excess(got.to(_BF), plain, chip_smoke.DEC_ATOL) <= 1.0


@pytest.mark.parametrize("kind", ["k9", "k8"])
def test_a_dropped_or_shifted_n_chunk_shows(kind):
    """chip_smoke.py's mutants of the head-less route (N chunk 1 left at
    zero, or stored 16 columns left of its offset) fail its bar."""
    rng = np.random.default_rng(136)
    cin, cout = 16, 136
    x = _bf(rng, (1, 4, 9, cin) if kind == "k9" else (1, 32, 9, cin))
    wt, bias = _bf(rng, (3, 3, cin, cout), (9 * cin) ** -0.5), _bf(rng, cout, 0.1)
    plain = dec.upsample_final_plain if kind == "k9" else dec.final_conv_gelu_plain
    ref = plain(x, wt, bias)
    geo = _tiling(kind, *x.shape, cout).head_geo
    assert len(geo.n_chunks) == 2
    for how in ("dropped", "shifted"):
        bad = chip_smoke._conv_chunk_mutant(ref, geo, how)
        assert chip_smoke._excess(bad, ref, chip_smoke.DEC_ATOL) > 1.0, how


def _n(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(20, 72), (96, 40)], ids=["20-72", "96-40"])
@pytest.mark.parametrize("kind", ["k9", "k8"])
def test_plain_matches_pallas_at_cin_other_than_cout(kind, shape):
    cin, cout = shape
    rng = np.random.default_rng([cin, cout, len(kind)])
    w, b = _n(rng, (3, 3, cin, cout), (9 * cin) ** -0.5), _n(rng, cout, 0.1)
    T, J = torch.from_numpy, jnp.asarray
    if kind == "k8":
        x = _n(rng, (1, 32, 10, cin))
        ref = jdec.fused_final_conv_gelu(J(x), J(w), J(b), rows=32, interpret=True)
        got = dec.final_conv_gelu(T(x), T(w), T(b))
    else:
        x = _n(rng, (1, 6, 10, cin))
        ref = jdec.fused_upsample_final(J(x), J(w), J(b), interpret=True)
        got = dec.upsample_final(T(x), T(w), T(b))
    _assert_elementwise(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
