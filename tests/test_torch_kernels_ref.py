"""The port's plain versions of the four kernels on the nuclei path against
the JAX package's Pallas kernels, run as the JAX tests run them on the CPU
(interpret mode). Inputs come from numpy with a seed and go to both.

On the CPU the port's wrappers take their plain versions (the tensors lie
on the CPU); chip_smoke.py holds the CUDA kernels against the same plain
versions on the card."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops import watershed as jws
from path_gene_multimodal_tpu.ops.components import INF as JINF
from path_gene_multimodal_tpu.ops.pallas.cc_sizes import (
    pallas_cc_sizes,
    pallas_cc_sizes_adaptive,
)
from path_gene_multimodal_tpu.ops.pallas.convnext_block import fused_convnext_block
from path_gene_multimodal_tpu.ops.pallas.flood import pallas_marker_watershed
from path_gene_multimodal_tpu.ops.pallas.instance_stats import (
    features_from_stats as j_features_from_stats,
    instance_stats_pallas,
    stats_center as j_stats_center,
)
from path_gene_multimodal_tpu_torch.ops import cc_sizes as tcc
from path_gene_multimodal_tpu_torch.ops import components as tcomp
from path_gene_multimodal_tpu_torch.ops.convnext_block import convnext_block
from path_gene_multimodal_tpu_torch.ops.flood import gpu_supported, marker_watershed
from path_gene_multimodal_tpu_torch.ops.instance_stats import (
    features_from_stats,
    instance_stats,
    stats_center,
)

T = torch.from_numpy


def _blobs(rng, b, h, w, thr=0.55, sigma=2.0):
    f = np.stack([gaussian_filter(rng.random((h, w)), sigma) for _ in range(b)])
    f = (f - f.min(axis=(1, 2), keepdims=True)) / np.ptp(f, axis=(1, 2), keepdims=True)
    return f > thr


def test_gpu_not_supported_on_cpu():
    assert gpu_supported() is False


# ---------------------------------------------------------------- K1


def _k1_both(hwc, exact_gelu):
    """K1's Pallas kernel (interpret mode) and the port's block on the CPU,
    on the same seeded bf16 input and f32 weights: (port, jax) as f32."""
    h, w, c = hwc
    rng = np.random.default_rng(h * 100 + c + int(exact_gelu))
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    ws = [
        rng.normal(scale=0.2, size=(7, 7, c)), rng.normal(scale=0.1, size=(c,)),
        1 + rng.normal(scale=0.1, size=(c,)), rng.normal(scale=0.1, size=(c,)),
        rng.normal(scale=c ** -0.5, size=(c, 4 * c)), rng.normal(scale=0.1, size=(4 * c,)),
        rng.normal(scale=0.5, size=(4 * c,)), rng.normal(scale=0.1, size=(4 * c,)),
        rng.normal(scale=(4 * c) ** -0.5, size=(4 * c, c)), rng.normal(scale=0.1, size=(c,)),
    ]
    ws = [a.astype(np.float32) for a in ws]
    ref = np.asarray(
        fused_convnext_block(
            jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, ws),
            exact_gelu=exact_gelu, interpret=True,
        ).astype(jnp.float32)
    )
    got = convnext_block(
        T(x).to(torch.bfloat16), *map(T, ws), exact_gelu=exact_gelu
    ).float().numpy()
    assert got.shape == ref.shape
    return got, ref


@pytest.mark.parametrize("exact_gelu", [False, True])
@pytest.mark.parametrize("hwc", [(8, 8, 16), (6, 10, 32)])
def test_k1_plain_matches_pallas_interpret(hwc, exact_gelu):
    """bf16 block: max |port - jax| / max |jax| <= 1e-2 (bf16 has 8
    mantissa bits; the two sides round the same operands but sum in other
    orders, so the outputs differ by at most a few bf16 ulps)."""
    got, ref = _k1_both(hwc, exact_gelu)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-2


@pytest.mark.parametrize("exact_gelu", [False, True])
@pytest.mark.parametrize("hwc", [(16, 16, 96), (8, 8, 192), (6, 10, 32)])
def test_k1_rounds_where_pallas_rounds(hwc, exact_gelu):
    """The port rounds where the TPU kernel rounds: the GRN affine reads
    the f32 GELU output y2 and only y3 is rounded to bf16 before pw2. Then
    the bf16 outputs differ from the Pallas kernel's only where sums taken
    in another order flip a final rounding (well under 1% of them); a bf16
    y2 before the GRN affine flips ~40% of them."""
    got, ref = _k1_both(hwc, exact_gelu)
    assert float((got != ref).mean()) <= 0.01


# ---------------------------------------------------------------- K2


def _check_cc(mask, s_slots, min_size):
    jl, js, jd = map(
        np.asarray,
        pallas_cc_sizes(jnp.asarray(mask), 1, s_slots=s_slots, min_size=min_size,
                        interpret=True),
    )
    tl, ts, td, tn = tcc.cc_sizes(T(mask), s_slots=s_slots, min_size=min_size)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(td.numpy(), jd)
    pix = np.arange(mask.shape[1] * mask.shape[2]).reshape(mask.shape[1:])
    np.testing.assert_array_equal(tn.numpy(), (jl == pix).sum(axis=(1, 2)))


@pytest.mark.parametrize("min_size", [0, 3])
def test_k2_plain_matches_pallas_interpret(rng, min_size):
    mask = _blobs(rng, 3, 40, 48)
    mask[1] = False  # an empty tile
    _check_cc(mask, 64, min_size)


def test_k2_slot_overflow_matches(rng):
    """More components than slots: ranks >= s_slots get size 0, dense 0."""
    mask = np.zeros((2, 24, 24), bool)
    mask[0, ::2, ::2] = True  # 144 single-pixel components
    mask[1] = _blobs(rng, 1, 24, 24, thr=0.5, sigma=1.0)[0]
    _check_cc(mask, 32, 1)


def test_k2_spiral_relaxation_cap():
    """A serpentine component takes many row/column passes; the plain
    version runs the same passes (and the same cap) as the TPU kernel."""
    mask = np.zeros((1, 32, 32), bool)
    for r in range(0, 32, 2):
        mask[0, r, :] = True
        mask[0, r + 1 if r + 1 < 32 else r, 31 if (r // 2) % 2 == 0 else 0] = True
    _check_cc(mask, 64, 0)


def test_k2_adaptive_contract(rng):
    """As tests/test_pallas_kernels.py:281-322: small/big budgets, the
    re-run at big when a tile overflows small, and per-tile overflow
    flags when a tile overflows big."""
    mask = np.zeros((2, 16, 16), bool)
    mask[0, ::2, ::2] = True  # 64 roots
    mask[1, 2:6, 2:6] = True
    for small, big in ((16, 128), (16, 32), (128, 256)):
        jl, js, jd, jo = map(
            np.asarray,
            pallas_cc_sizes_adaptive(jnp.asarray(mask), 1, min_size=1, small=small,
                                     big=big, interpret=True, count_overflow=True),
        )
        tl, ts, td, to = tcc.cc_sizes_adaptive(T(mask), min_size=1, small=small, big=big)
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(td.numpy(), jd)
        np.testing.assert_array_equal(to.numpy(), jo)
    assert to.numpy().tolist() == [False, False]
    _, _, _, to = tcc.cc_sizes_adaptive(T(mask), min_size=1, small=16, big=32)
    assert to.numpy().tolist() == [True, False]


def test_components_helpers_match_jax(rng):
    from path_gene_multimodal_tpu.ops.components import (
        component_sizes_batch as j_sizes,
        label_components as j_label,
    )
    from path_gene_multimodal_tpu.ops.instances import compact_labels_device as j_compact

    mask = _blobs(rng, 2, 32, 40)
    jl = np.stack([np.asarray(j_label(jnp.asarray(m), 1)) for m in mask])
    tl = tcomp.label_components(T(mask))
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(
        tcomp.component_sizes_batch(tl).numpy(), np.asarray(j_sizes(jnp.asarray(jl)))
    )
    np.testing.assert_array_equal(
        tcomp.compact_labels_device(tl).numpy(),
        np.asarray(j_compact(jnp.asarray(jl))).astype(np.int32),
    )


# ---------------------------------------------------------------- K3


def _flood_inputs(rng, b, h, w, n_markers=6):
    dist = np.stack([gaussian_filter(rng.random((h, w)), 3) for _ in range(b)])
    dist = ((dist - dist.min()) / np.ptp(dist)).astype(np.float32)
    mask = dist > 0.15
    markers = np.full((b, h, w), int(JINF), np.int32)
    for bi in range(b):
        ys, xs = rng.integers(0, h, n_markers), rng.integers(0, w, n_markers)
        markers[bi, ys, xs] = np.arange(1, n_markers + 1)
        markers[bi][~mask[bi]] = int(JINF)
    return dist, markers, mask


@pytest.mark.parametrize("levels", [64, 16])
def test_k3_plain_matches_pallas_interpret(rng, levels):
    dist, markers, mask = _flood_inputs(rng, 2, 40, 56)
    ref = np.asarray(pallas_marker_watershed(
        jnp.asarray(dist), jnp.asarray(markers), jnp.asarray(mask), levels=levels,
        interpret=True,
    ))
    got = marker_watershed(T(dist), T(markers), T(mask), levels=levels)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k3_min_index_labels(rng):
    """Non-dense markers (min pixel-index labels, large values) flood the
    same way."""
    dist, markers, mask = _flood_inputs(rng, 1, 32, 32)
    big = np.where(markers < JINF, markers * 1000 + 70000, markers).astype(np.int32)
    ref = np.asarray(pallas_marker_watershed(
        jnp.asarray(dist), jnp.asarray(big), jnp.asarray(mask), interpret=True))
    got = marker_watershed(T(dist), T(big), T(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k3_round_cap_follows_pallas_not_xla():
    """An 8x128 all-foreground tile, dist = 0, one marker at (0, 0): the
    Pallas kernel runs 65 synchronous steps per phase and reaches 66
    columns, the XLA flood runs 64 and reaches 65. The port follows the
    Pallas kernel."""
    dist = np.zeros((1, 8, 128), np.float32)
    mask = np.ones((1, 8, 128), bool)
    markers = np.full((1, 8, 128), int(JINF), np.int32)
    markers[0, 0, 0] = 1
    pls = np.asarray(pallas_marker_watershed(
        jnp.asarray(dist), jnp.asarray(markers), jnp.asarray(mask), interpret=True))
    xla = np.asarray(jws.marker_watershed(
        jnp.asarray(dist[0]), jnp.asarray(markers[0]), jnp.asarray(mask[0])))
    got = marker_watershed(T(dist), T(markers), T(mask)).numpy()
    reach = lambda a: int((a < JINF).any(axis=0).sum())  # noqa: E731
    assert reach(pls[0]) == 66 and reach(xla) == 65
    np.testing.assert_array_equal(got, pls)
    assert not np.array_equal(got[0], xla)


# ---------------------------------------------------------------- K4


def _stats_inputs(rng, b=2, s=48, max_inst=32):
    lbl = np.zeros((b, s, s), np.int32)
    tp = np.zeros((b, s, s), np.int32)
    yy, xx = np.mgrid[0:s, 0:s]
    for bi in range(b):
        for inst in range(1, 20):
            cy, cx = rng.integers(3, s - 3, 2)
            ry, rx = rng.integers(1, 7, 2)
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            lbl[bi][m] = inst
            tp[bi][m] = rng.integers(0, 6, size=int(m.sum()))
    lbl[0, 0:2, 0:3] = max_inst + 5  # ids >= S are ignored
    lbl[1, -3:, -2:] = max_inst
    return lbl, tp


def test_k4_plain_matches_pallas_interpret(rng):
    """Counts, votes and bbox identical; second moments at atol 1e-3 /
    rtol 1e-5: the port sums exact integers and rounds to f32 once, the
    TPU kernel accumulates them in f32, which rounds once a sum passes
    2^24."""
    max_inst = 32
    lbl, tp = _stats_inputs(rng, max_inst=max_inst)
    js, jm = map(np.asarray, instance_stats_pallas(
        jnp.asarray(lbl), jnp.asarray(tp), max_inst, interpret=True))
    ts, tm = instance_stats(T(lbl), T(tp), max_inst)
    ts, tm = ts.numpy(), tm.numpy()
    assert ts.shape == js.shape and tm.shape == jm.shape
    exact = [0, 1, 2] + list(range(6, js.shape[-1]))
    np.testing.assert_array_equal(ts[..., exact], js[..., exact])
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(ts[..., 3:6], js[..., 3:6], atol=1e-3, rtol=1e-5)

    s = lbl.shape[1]
    jf = j_features_from_stats(jnp.asarray(js), jnp.asarray(jm), 6,
                               center=j_stats_center(s, s))
    tf = features_from_stats(T(ts), T(tm), 6, center=stats_center(s, s))
    assert set(tf) == set(jf)
    for k in jf:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_k4_large_tile_moments(rng):
    """One instance covering most of a 224 tile: moment sums far above
    2^24, still within the stated tolerance of the TPU kernel's."""
    lbl = np.ones((1, 224, 224), np.int32)
    lbl[0, :10] = 0
    tp = rng.integers(0, 6, size=lbl.shape).astype(np.int32)
    js, jm = map(np.asarray, instance_stats_pallas(
        jnp.asarray(lbl), jnp.asarray(tp), 8, interpret=True))
    ts, tm = instance_stats(T(lbl), T(tp), 8)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-3, rtol=1e-5)
