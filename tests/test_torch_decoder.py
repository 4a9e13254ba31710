"""The port's decoder kernels (K7-K11) and decoder configurations against
the JAX package, on the CPU.

Each plain version is held against its Pallas kernel run as
``tests/test_hovernext_fused.py`` runs it (``interpret=True``), elementwise
within 2 bf16 ulp(|jax|) + 1e-3: both sides round the same operands to bf16
and differ only in the order of their f32 sums, which can flip the last
rounding of an output. The weight folds match in f32, and the port's TTA
forward in each configuration matches ``hovernext_forward`` with the same
option. Inputs come from numpy with a seed and go to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.models import hovernext_fn as jfn
from path_gene_multimodal_tpu.models.hovernext import HoverNeXt as JHoverNeXt
from path_gene_multimodal_tpu.models.hovernext import tta_forward as j_tta_forward
from path_gene_multimodal_tpu.ops.pallas import decoder as jdec
from path_gene_multimodal_tpu_torch.models import hovernext_fn as tfn
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt, tta_forward
from path_gene_multimodal_tpu_torch.models.weights_hovernext import params_from_jax
from path_gene_multimodal_tpu_torch.ops import decoder as tdec
from test_torch_hovernext import _configs

T = torch.from_numpy
GELU_MODES = pytest.mark.parametrize("exact_gelu", [False, True], ids=["tanh", "erf"])


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    m, e = np.frexp(np.abs(x).astype(np.float32))
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))


def _assert_elementwise(got: np.ndarray, ref: np.ndarray, atol: float = 1e-3) -> None:
    assert got.shape == ref.shape
    excess = np.abs(got - ref) / (2 * _bf16_ulp(ref) + atol)
    assert excess.max() <= 1.0, (excess.max(), np.abs(got - ref).max())


def _rel_span(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / ((ref.max() - ref.min()) or 1.0))


def _normal(rng, shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


def _jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def jax_params():
    """JAX HoverNeXt parameters for the configuration of
    ``tests/test_torch_hovernext.py`` (the same tree in both GELU modes),
    GRN randomised as there; ``init`` jitted whole, which compiles once."""
    jcfg, _ = _configs(False)
    params = jax.jit(JHoverNeXt(jcfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, params)
    for k, blk in params["params"]["encoder"].items():
        if k.startswith("stage"):
            for n in ("gamma", "beta"):
                blk["grn"][n] = rng.normal(scale=0.3, size=blk["grn"][n].shape).astype(np.float32)
    return params


# ---------------------------------------------------------------- K7


@GELU_MODES
@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "noskip"])
def test_k7_plain_matches_pallas_interpret(with_skip, exact_gelu):
    rng = np.random.default_rng(70 + 2 * with_skip + exact_gelu)
    b, h, w, cx, cs, cout = 2, 12, 10, 8, 4, 16
    x = _normal(rng, (b, h, w, cx))
    skip = _normal(rng, (b, h, w, cs)) if with_skip else None
    cin = cx + (cs if with_skip else 0)
    wk = _normal(rng, (3, 3, cin, cout), 0.2)
    bias, scale, lnb = _normal(rng, cout, 0.1), _normal(rng, cout, 0.1, 1.0), _normal(rng, cout, 0.1)
    ref = np.asarray(jdec.fused_decoder_conv(
        jnp.asarray(x), None if skip is None else jnp.asarray(skip), *_jnp(wk, bias, scale, lnb),
        exact_gelu=exact_gelu, interpret=True).astype(jnp.float32))
    got = tdec.decoder_conv(T(x), None if skip is None else T(skip), T(wk), T(bias), T(scale),
                            T(lnb), exact_gelu=exact_gelu)
    assert got.dtype == torch.bfloat16
    _assert_elementwise(got.float().numpy(), ref)


# ---------------------------------------------------------------- K8


@GELU_MODES
@pytest.mark.parametrize("h", [32, 64], ids=["one_strip", "strip_edges"])
def test_k8_plain_matches_pallas_interpret(h, exact_gelu):
    rng = np.random.default_rng(80 + h + exact_gelu)
    b, c, cout = 2, 8, 8
    x = _normal(rng, (b, h, h, c))
    wk, bias = _normal(rng, (3, 3, c, cout), 0.2), _normal(rng, cout, 0.1)
    ref = np.asarray(jdec.fused_final_conv_gelu(
        *_jnp(x, wk, bias), rows=32, exact_gelu=exact_gelu, interpret=True).astype(jnp.float32))
    got = tdec.final_conv_gelu(T(x), T(wk), T(bias), exact_gelu=exact_gelu)
    _assert_elementwise(got.float().numpy(), ref)


# ---------------------------------------------------------------- K9


@GELU_MODES
def test_k9_plain_matches_pallas_interpret(exact_gelu):
    """The pattern of ``test_hovernext_fused.py:134``; the Pallas kernel
    honours ``exact_gelu``, so both modes go against it."""
    rng = np.random.default_rng(90 + exact_gelu)
    b, h, w, cin, cout = 2, 8, 12, 6, 8
    x = _normal(rng, (b, h, w, cin))
    wk, bias = _normal(rng, (3, 3, cin, cout), 0.2), _normal(rng, cout, 0.1)
    ref = np.asarray(jdec.fused_upsample_final(*_jnp(x, wk, bias), exact_gelu=exact_gelu,
                                               interpret=True).astype(jnp.float32))
    got = tdec.upsample_final(T(x), T(wk), T(bias), exact_gelu=exact_gelu)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 2 * h, 2 * w, cout)
    _assert_elementwise(got.float().numpy(), ref)
    other = tdec.upsample_final_plain(T(x), T(wk), T(bias), exact_gelu=not exact_gelu)
    assert not torch.equal(got, other)


def test_k9_rejects_2h_not_multiple_of_4():
    """As the TPU kernel (``decoder.py:318-322``): its 4 row chunks would
    leave rows unwritten."""
    x = torch.zeros(1, 3, 4, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        tdec.upsample_final(x, torch.zeros(3, 3, 32, 64), torch.zeros(64))
    with pytest.raises(ValueError, match="multiple of 4"):
        jdec.fused_upsample_final(jnp.asarray(x.numpy()), jnp.zeros((3, 3, 32, 64)),
                                  jnp.zeros(64), interpret=True)


# ---------------------------------------------------------------- K10


def _k10_inputs(rng):
    b, h, w, cin, cout, n_out = 2, 8, 12, 6, 8, 10
    return (_normal(rng, (b, h, w, cin)), _normal(rng, (3, 3, cin, cout), 0.2),
            _normal(rng, cout, 0.1), _normal(rng, (cout, n_out), 0.3), _normal(rng, n_out, 0.1))


def test_k10_plain_matches_pallas_interpret_tanh():
    x, wk, bias, wh, bh = _k10_inputs(np.random.default_rng(100))
    ref = jdec.fused_final_heads(*_jnp(x, wk, bias, wh, bh), interpret=True)
    ref = np.asarray(jnp.transpose(ref, (0, 2, 3, 1)).astype(jnp.float32))
    got = tdec.final_heads(*map(T, (x, wk, bias, wh, bh)))
    _assert_elementwise(got.float().numpy(), ref)


def test_k10_plain_exact_gelu_matches_xla_chain():
    """In exact mode the Pallas kernel computes tanh GELU (its
    ``_chunk_conv_gelu`` call drops ``exact_gelu``), against its own
    docstring. The port honours the flag, so it is held against the XLA
    chain resize → conv → exact GELU → heads, at the JAX tests' bar of 2e-2
    of max |ref| (``test_hovernext_fused.py:190-191``): the chain keeps f32
    where the kernel rounds to bf16."""
    x, wk, bias, wh, bh = _k10_inputs(np.random.default_rng(101))
    b, h, w, cin = x.shape
    up = jax.image.resize(jnp.asarray(x), (b, 2 * h, 2 * w, cin), method="bilinear")
    y = jfn._conv({"kernel": jnp.asarray(wk), "bias": jnp.asarray(bias)}, up, stride=1, pad=1,
                  dtype=jnp.float32)
    ref = np.asarray(jax.nn.gelu(y, approximate=False)) @ wh + bh
    got = tdec.final_heads(*map(T, (x, wk, bias, wh, bh)), exact_gelu=True).float().numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
    tanh = tdec.final_heads(*map(T, (x, wk, bias, wh, bh)), exact_gelu=False).float().numpy()
    assert not np.array_equal(got, tanh)


# ---------------------------------------------------------------- K11


def _final_params(rng, cin, cout):
    p = {"final_conv": {"kernel": _normal(rng, (3, 3, cin, cout), 0.2),
                        "bias": _normal(rng, cout, 0.1)}}
    for n, d in (("head_np", 2), ("head_hv", 2), ("head_tp", 6)):
        p[n] = {"kernel": _normal(rng, (1, 1, cout, d), 0.3), "bias": _normal(rng, d, 0.1)}
    return p


def _j_block_diag(wcat, bcat):
    """The JAX package's block-diagonal head (``hovernext_fn.py:279-281``)."""
    cout, n_out = wcat.shape
    wh_bd = jnp.einsum("pq,cn->pcqn", jnp.eye(4, dtype=wcat.dtype), wcat)
    return wh_bd.reshape(4 * cout, 4 * n_out), jnp.tile(bcat, 4)


@GELU_MODES
def test_k11_plain_matches_pallas_interpret(exact_gelu):
    rng = np.random.default_rng(110 + exact_gelu)
    cin, cout = 8, 8
    p = _final_params(rng, cin, cout)
    jp = jax.tree.map(jnp.asarray, p)
    wc, bias4, wcat, bcat = jfn._lowres_head_weights(jp, jp["final_conv"], jnp.float32)
    wh_bd, bh4 = _j_block_diag(wcat, bcat)
    x = _normal(rng, (2, 9, 7, cin))
    ref = np.asarray(jdec.composite_final_heads(
        jnp.asarray(x), wc, bias4, wh_bd, bh4, exact_gelu=exact_gelu, interpret=True
    ).astype(jnp.float32))
    got = tdec.composite_final_heads(T(x), *(T(np.array(a)) for a in (wc, bias4, wh_bd, bh4)),
                                     exact_gelu=exact_gelu)
    _assert_elementwise(got.float().numpy(), ref)


# ------------------------------------------- K9/K10 kernel tiling geometry


def _taps(o: np.ndarray, n: int):
    """The bilinear 2x taps of output indices ``o`` along an axis of ``n``
    input samples, edge clamped (``jax.image.resize`` at 2x)."""
    i, odd = o // 2, o % 2 == 1
    i0 = np.where(odd, i, np.maximum(i - 1, 0))
    i1 = np.where(odd, np.minimum(i + 1, n - 1), i)
    a0 = np.where(odd, 0.75, 0.25).astype(np.float32)
    return i0, i1, a0, (1 - a0).astype(np.float32)


@pytest.mark.parametrize("hw", [(4, 4), (6, 10), (34, 34), (128, 128), (9, 21)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_upsample_tiling_windows_cover_the_halo_taps(hw):
    """``UpsampleTiling``, the K9/K10 kernel's launch geometry, on half-res
    inputs whose output is and is not a multiple of the 8 x 64 tile: every
    output pixel lies in exactly one tile; every low-res index that the
    bilinear taps of a tile's halo read (edge clamp included) lies in the
    tile's window; a halo built from the window alone (NaN outside it), the
    kernel's way, equals the upsampled map zero-padded, so its out-of-image
    ring is exactly the conv's zero padding; a 3x3 conv over the halos
    reassembles the conv of the whole map; shared memory fits a block."""
    h, w = hw
    geo = tdec.UpsampleTiling(2, h, w, n_sm=132)
    oh, ow = geo.out_hw
    ty_n, tx_n = geo.tiles_yx
    assert (oh, ow) == (2 * h, 2 * w)
    assert (ty_n - 1) * geo.tile_h < oh <= ty_n * geo.tile_h
    assert (tx_n - 1) * geo.tile_w < ow <= tx_n * geo.tile_w
    assert geo.n_tiles == 2 * ty_n * tx_n and geo.grid == min(geo.n_tiles, 132)
    assert geo.smem_bytes == 210_432
    head = tdec.UpsampleTiling(2, h, w, head=True)
    assert head.smem_bytes == 213_504 <= tdec.SMEM_PER_BLOCK
    assert head.launch_args() == (8, 64, head.grid, 213_504)

    rng = np.random.default_rng(h * 100 + w)
    c = 3
    x = _normal(rng, (1, h, w, c))
    up = tdec.upsample2x_bilinear(T(x))[0].numpy()
    th, tw = geo.tile_h, geo.tile_w
    zpad = np.zeros((ty_n * th + 2, tx_n * tw + 2, c), np.float32)
    zpad[1 : oh + 1, 1 : ow + 1] = up
    wk = _normal(rng, (3, 3, c, 4), 0.2)
    whole = tdec._conv3x3(T(up[None]), T(wk))[0].numpy()
    tiled = np.full((ty_n * th, tx_n * tw, 4), np.nan, np.float32)
    (hh, hw_), (wh, ww) = geo.halo_shape, geo.window_shape
    for ty in range(ty_n):
        for tx in range(tx_n):
            wy0, wx0 = geo.window_origin(ty, tx)
            win = np.full((wh, ww, c), np.nan, np.float32)
            ys, xs = np.arange(wy0, wy0 + wh), np.arange(wx0, wx0 + ww)
            iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
            win[np.ix_(iy, ix)] = x[0][np.ix_(ys[iy], xs[ix])]
            hy0, hx0 = geo.halo_origin(ty, tx)
            oy, ox = np.arange(hy0, hy0 + hh), np.arange(hx0, hx0 + hw_)
            in_y, in_x = (oy >= 0) & (oy < oh), (ox >= 0) & (ox < ow)
            r0, r1, ra, rb = _taps(oy[in_y], h)
            c0, c1, ca, cb = _taps(ox[in_x], w)
            for t in (r0, r1):
                assert ((t - wy0 >= 0) & (t - wy0 < wh)).all(), (ty, tx, t, wy0)
            for t in (c0, c1):
                assert ((t - wx0 >= 0) & (t - wx0 < ww)).all(), (ty, tx, t, wx0)
            r0, r1, c0, c1 = r0 - wy0, r1 - wy0, c0 - wx0, c1 - wx0
            # rows first, then columns, each product and sum in f32
            u0 = ra[:, None, None] * win[r0][:, c0] + rb[:, None, None] * win[r1][:, c0]
            u1 = ra[:, None, None] * win[r0][:, c1] + rb[:, None, None] * win[r1][:, c1]
            halo = np.zeros((hh, hw_, c), np.float32)
            halo[np.ix_(in_y, in_x)] = ca[None, :, None] * u0 + cb[None, :, None] * u1
            np.testing.assert_array_equal(halo, zpad[hy0 + 1 : hy0 + 1 + hh, hx0 + 1 : hx0 + 1 + hw_])
            conv = torch.nn.functional.conv2d(T(halo).permute(2, 0, 1)[None],
                                              T(wk).permute(3, 2, 0, 1))
            tiled[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw] = conv[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(tiled[:oh, :ow], whole, atol=1e-5, rtol=0)


# ------------------------------------------------------- upsample, folds


def test_upsample2x_bilinear_matches_jax():
    x = _normal(np.random.default_rng(120), (2, 9, 7, 5))
    ref = np.asarray(jdec.upsample2x_bilinear(jnp.asarray(x)))
    np.testing.assert_allclose(tdec.upsample2x_bilinear(T(x)).numpy(), ref, atol=1e-6, rtol=0)
    rsz = np.asarray(jax.image.resize(jnp.asarray(x), (2, 18, 14, 5), method="bilinear"))
    np.testing.assert_allclose(tdec.upsample2x_bilinear(T(x)).numpy(), rsz, atol=1e-5, rtol=0)


def test_upsample2x_nearest_matches_jax():
    x = _normal(np.random.default_rng(121), (2, 5, 6, 3))
    np.testing.assert_array_equal(tdec.upsample2x_nearest(T(x)).numpy(),
                                  np.asarray(jdec.upsample2x_nearest(jnp.asarray(x))))


def test_composite_and_head_folds_match_jax():
    rng = np.random.default_rng(122)
    p = _final_params(rng, 8, 8)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(T, p)
    j = jfn._lowres_head_weights(jp, jp["final_conv"], jnp.float32)
    t = tfn._lowres_head_weights(tp, tp["final_conv"], torch.float32)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    jwc = jfn._composite_final_weights(jp["final_conv"]["kernel"])
    np.testing.assert_allclose(tfn._composite_final_weights(tp["final_conv"]["kernel"]).numpy(),
                               np.asarray(jwc), atol=1e-6, rtol=0)
    for a, b in zip(tfn._block_diag_heads(t[2], t[3]), _j_block_diag(j[2], j[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    z = _normal(rng, (2, 3, 4, 40))
    np.testing.assert_array_equal(tfn._parity_to_fullres(T(z), 10).numpy(),
                                  np.asarray(jfn._parity_to_fullres(jnp.asarray(z), 10)))


def test_kernel_weights_match_the_jax_kernel_operands(jax_params):
    """What ``HoverNeXt.fuse`` holds equals what the JAX wrappers hand their
    kernels: K7's x and skip halves (``decoder.py:200``, :213), K8's and
    K10's conv weights, K10's concatenated heads, K11's folds."""
    _, tcfg = _configs(False)
    params = jax_params
    p = params["params"]
    bf = lambda a: np.asarray(a).astype(jnp.bfloat16).astype(np.float32)  # noqa: E731
    sd = params_from_jax(params, tcfg)
    for kwargs in ({"fused_decoder": True}, {"fused_final": "heads"}, {"fused_final": "pallas"},
                   {"fused_final": True}):
        model = HoverNeXt(tcfg, **kwargs).eval()
        model.load_state_dict(sd)
        model.fuse()
        kw = model.fused_weights
        if "k7" in kw:
            cxs = [tcfg.encoder.dims[-1]] + list(tcfg.decoder_dims[:-1])
            for i, (w0, w1) in enumerate(kw["k7"]):
                jw = p[f"dec{i}"]["conv0"]["kernel"]
                cx = cxs[i]
                np.testing.assert_array_equal(w0[0][:, :, :cx].float().numpy(), bf(jw[:, :, :cx]))
                np.testing.assert_array_equal(w0[0][:, :, cx:].float().numpy(), bf(jw[:, :, cx:]))
                np.testing.assert_array_equal(w0[2].float().numpy(), bf(p[f"dec{i}"]["norm0"]["scale"]))
                np.testing.assert_array_equal(w1[0].float().numpy(), bf(p[f"dec{i}"]["conv1"]["kernel"]))
            np.testing.assert_array_equal(kw["k8"][0].float().numpy(), bf(p["final_conv"]["kernel"]))
        if "k9" in kw:
            np.testing.assert_array_equal(kw["k9"][0].float().numpy(), bf(p["final_conv"]["kernel"]))
            np.testing.assert_array_equal(kw["k9"][1].float().numpy(), bf(p["final_conv"]["bias"]))
        if "k10" in kw:
            wcat, bcat = jfn._head_cat(p, tcfg.decoder_dims[-1], jnp.float32)
            np.testing.assert_array_equal(kw["k10"][2].float().numpy(), bf(wcat))
            np.testing.assert_array_equal(kw["k10"][3].float().numpy(), bf(bcat))
        if "k11" in kw:
            jp = jax.tree.map(jnp.asarray, p)
            wc, bias4, wcat, bcat = jfn._lowres_head_weights(jp, jp["final_conv"], jnp.float32)
            wh_bd, bh4 = _j_block_diag(wcat, bcat)
            for a, b in zip(kw["k11"][:4], (wc, bias4, wh_bd, bh4)):
                assert a.dtype == torch.bfloat16 and a.is_contiguous()
                np.testing.assert_array_equal(a.float().numpy(), bf(b))


# ---------------------------------------------------------- the slice


def _slice(params, exact_gelu, seed):
    jcfg, tcfg = _configs(exact_gelu)
    x = np.random.default_rng(seed).uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    sd = params_from_jax(params, tcfg)
    return jcfg, tcfg, params, x, sd


def _run(jcfg, tcfg, params, x, sd, port_kw, jax_kw):
    model = HoverNeXt(tcfg, **port_kw).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tta_forward(model, T(x), tta=4)
    fwd = lambda p, px: jfn.hovernext_forward(  # noqa: E731
        p, px, jcfg, dtype=jnp.float32, interpret=True, **jax_kw)
    ref = j_tta_forward(fwd, params, jnp.asarray(x), tta=4, fold_batch=True)
    return {k: (got[k].numpy(), np.asarray(ref[k])) for k in ("np", "hv", "tp")}


@GELU_MODES
@pytest.mark.parametrize("option", [{"fused_decoder": True}, {"fused_final": "pallas"},
                                    {"fused_final": True}],
                         ids=["fused_decoder", "pallas", "k9"])
def test_slice_kernel_configs_match_jax(jax_params, option, exact_gelu):
    """bf16-level: max |port - jax| / span < 2e-2, the JAX package's own bar
    for its kernel configurations (``test_hovernext_fused.py:304``, :322)."""
    jcfg, tcfg, params, x, sd = _slice(jax_params, exact_gelu, seed=11)
    for k, (got, ref) in _run(jcfg, tcfg, params, x, sd, option, option).items():
        assert got.shape == ref.shape
        assert _rel_span(got, ref) < 2e-2, k


@GELU_MODES
def test_slice_heads_matches_jax(jax_params, exact_gelu):
    """``fused_final="heads"``: against the JAX K10 configuration in tanh
    mode; in exact mode against the JAX plain path (``fused_final=False``),
    since the JAX K10 computes tanh GELU there (see the K10 exact test)."""
    jcfg, tcfg, params, x, sd = _slice(jax_params, exact_gelu, seed=13)
    jax_kw = {"fused_final": False if exact_gelu else "heads"}
    for k, (got, ref) in _run(jcfg, tcfg, params, x, sd, {"fused_final": "heads"},
                              jax_kw).items():
        assert _rel_span(got, ref) < 2e-2, k


@GELU_MODES
def test_slice_lowres_matches_jax(jax_params, exact_gelu):
    """``fused_final="lowres"`` is f32 plain on both sides."""
    jcfg, tcfg, params, x, sd = _slice(jax_params, exact_gelu, seed=15)
    for k, (got, ref) in _run(jcfg, tcfg, params, x, sd, {"fused_final": "lowres"},
                              {"fused_final": "lowres"}).items():
        np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3, err_msg=k)


@GELU_MODES
def test_slice_lowres_decoder_matches_jax(jax_params, exact_gelu):
    """``lowres_decoder=True`` is f32 plain on both sides; it also equals
    the port's hi-res decoder up to f32 rounding
    (``test_hovernext_fused.py:153``)."""
    jcfg, tcfg, params, x, sd = _slice(jax_params, exact_gelu, seed=19)
    res = _run(jcfg, tcfg, params, x, sd, {"lowres_decoder": True}, {"lowres_decoder": True})
    for k, (got, ref) in res.items():
        np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3, err_msg=k)
    hires = HoverNeXt(tcfg).eval()
    hires.load_state_dict(sd)
    with torch.no_grad():
        ref = hires(T(x))
    lowres = HoverNeXt(tcfg, lowres_decoder=True).eval()
    lowres.load_state_dict(sd)
    with torch.no_grad():
        got = lowres(T(x))
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=1e-4, rtol=1e-4)


def test_fused_weights_give_the_same_forward(jax_params):
    """``fuse()`` changes where the decoder kernels' weights come from, not
    what the forward computes (the encoder runs K1 on both sides)."""
    _, tcfg, _, x, sd = _slice(jax_params, False, seed=17)
    for option in ({"fused_decoder": True}, {"fused_final": "heads"},
                   {"fused_final": "pallas"}):
        model = HoverNeXt(tcfg, **option).eval()
        model.load_state_dict(sd)
        model.encoder.fuse()
        with torch.no_grad():
            a = model(T(x))
            model.fuse()
            b = model(T(x))
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)


# ---------------------------------------------------------- options


def test_fused_decoder_with_fused_final_raises():
    _, tcfg = _configs(False)
    for ff in (False, "lowres", "pallas", "heads", True):
        with pytest.raises(ValueError, match="fused_decoder"):
            HoverNeXt(tcfg, fused_decoder=True, fused_final=ff)
    with pytest.raises(ValueError, match="lowres_decoder"):
        HoverNeXt(tcfg, fused_decoder=True, lowres_decoder=True)
    with pytest.raises(ValueError, match="features"):
        HoverNeXt(tcfg, fused_decoder=True).features(torch.zeros(1, 64, 64, 3))


def test_fused_final_true_builds_k9_weights():
    """``fused_final=True`` (K9) builds and holds K9's weights; an unknown
    option still raises."""
    _, tcfg = _configs(False)
    model = HoverNeXt(tcfg, fused_final=True)
    assert model.fused_final is True and set(model.kernel_weights()) == {"k9"}
    with pytest.raises(ValueError, match="fused_final"):
        HoverNeXt(tcfg, fused_final="xla")


def test_default_is_the_plain_final_stage():
    """``fused_final=None`` is the port's default: the plain resize path,
    not the JAX default "lowres"."""
    _, tcfg = _configs(False)
    assert HoverNeXt(tcfg).fused_final is False
    assert HoverNeXt(tcfg, fused_final=None).fused_decoder is False
