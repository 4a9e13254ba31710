"""Where the port's kernels and the Pallas kernels take different shapes,
and the f32 path's cuDNN precision, on the CPU.

- Wider on the card: ``final_heads`` (K10) and ``final_conv_gelu`` (K8)
  refuse the H that ``fused_final_heads`` / ``fused_final_conv_gelu``
  refuse, on both devices.
- The same widths on the card: ``HoverNeXt(...)`` and ``fuse()``
  build every decoder configuration for any encoder and decoder
  widths (the small test configuration, ConvNeXtV2-nano's canonical
  HoverNeXt, and the same encoder with decoder widths 320/160/80/40 and 12
  types); the kernels' tiling classes take each of their calls' shapes
  within a block's shared memory, on the route the shape needs; the plain
  versions equal the Pallas kernels in interpret mode at the shapes the
  card's own kernels do not take (their any route's), within
  ``test_torch_decoder.py``'s bar; a width past 1024 runs on the any
  route (K10 and K11 on the wide head route), and only a head's input past
  ``HEAD_MAX_WIDTH`` channels is refused by the kernel's tiling class,
  which names the kernel and the limit.
- TF32: an f32 ``HoverNeXt`` forward runs its convs with
  ``torch.backends.cudnn.allow_tf32`` off, and restores it after.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.models import hovernext_fn as jfn
from path_gene_multimodal_tpu.ops.pallas import decoder as jdec
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt
from path_gene_multimodal_tpu_torch.ops import decoder as tdec
from test_torch_decoder import _assert_elementwise, _final_params, _j_block_diag
from test_torch_hovernext import _configs

CONFIGS = {"k9": {"fused_final": True}, "heads": {"fused_final": "heads"},
           "pallas": {"fused_final": "pallas"}, "fused_decoder": {"fused_decoder": True}}
NANO = ConvNeXtConfig(depths=(2, 2, 8, 2), dims=(80, 160, 320, 640))
MODELS = {"small": None,
          "nano": HoverNeXtConfig(encoder=NANO),  # (a): K7 sees the skip of 80
          "nano_dec40": HoverNeXtConfig(encoder=NANO, decoder_dims=(320, 160, 80, 40),
                                        num_types=12)}  # (b): n_out 17


@pytest.mark.parametrize("h", [3, 5, 4, 6])
def test_final_heads_refuses_what_the_pallas_kernel_refuses(h):
    rng = np.random.default_rng(h)
    x = rng.standard_normal((1, h, 4, 8)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 8, 8))).astype(np.float32)
    b, wh, bh = np.zeros(8, np.float32), np.zeros((8, 10), np.float32), np.zeros(10, np.float32)
    args = [torch.from_numpy(a) for a in (x, w, b, wh, bh)]
    if (2 * h) % 4:
        with pytest.raises(ValueError, match="multiple of 4"):
            tdec.final_heads(*args)
        with pytest.raises(ValueError, match="divisible by 4"):
            jdec.fused_final_heads(*map(jnp.asarray, (x, w, b, wh, bh)), interpret=True)
    else:
        assert tdec.final_heads(*args).shape == (1, 2 * h, 8, 10)


@pytest.mark.parametrize("h", [16, 40, 32])
def test_final_conv_gelu_refuses_what_the_pallas_kernel_refuses(h):
    rng = np.random.default_rng(h)
    x = rng.standard_normal((1, h, 8, 8)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 8, 8))).astype(np.float32)
    b = np.zeros(8, np.float32)
    if h % 32:
        with pytest.raises(ValueError, match="multiple of rows=32"):
            tdec.final_conv_gelu(*map(torch.from_numpy, (x, w, b)))
        with pytest.raises(ValueError, match="multiple of rows=32"):
            jdec.fused_final_conv_gelu(*map(jnp.asarray, (x, w, b)), interpret=True)
    else:
        assert tdec.final_conv_gelu(*map(torch.from_numpy, (x, w, b))).shape == (1, h, 8, 8)


def _kernel_tilings(cfg: HoverNeXtConfig, name: str, batch: int = 2):
    """(call, tiling) of each kernel call a forward of ``cfg`` makes in
    configuration ``name`` at its input size, as the wrappers build them."""
    d, dec, side = cfg.encoder.dims, cfg.decoder_dims, cfg.input_size
    last, n_out = dec[-1], 4 + cfg.tp_channels
    half = side // 2
    if name == "fused_decoder":
        out = []
        for i, (cx, cs, c) in enumerate(zip([d[-1]] + list(dec[:-1]),
                                            (d[2], d[1], d[0], 0), dec)):
            hw = side // 2 ** (4 - i)
            out.append((f"dec{i}.conv0", tdec.DecoderConvTiling(batch, hw, hw, cx, cs, c)))
            out.append((f"dec{i}.conv1", tdec.DecoderConvTiling(batch, hw, hw, c, 0, c)))
        return out + [("final", tdec.StripTiling(batch, side, side, cin=last, cout=last))]
    if name == "k9":
        return [("final", tdec.UpsampleTiling(batch, half, half, cin=last, cout=last))]
    if name == "heads":
        return [("final", tdec.UpsampleTiling(batch, half, half, head=True, cin=last,
                                              cout=last, n_out=n_out))]
    return [("final", tdec.StripTiling(batch, half, half, phases=4, cin=last, cout=last,
                                       n_out=n_out))]


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_hovernext_builds_every_configuration_on_the_card(name, model):
    """Every decoder configuration builds for the card and fuses, for the
    small test configuration (decoder 32/16/8/8), ConvNeXtV2-nano's
    canonical HoverNeXt and the same encoder with decoder widths
    320/160/80/40 and 12 types; each of its kernel calls' tilings takes its
    shape within a block's shared memory, on the kernels' own compiled
    widths where they take it (HoverNeXt-tiny's route), on the wide kernel
    at K8-K11's other widths and on K7's any route at K7's."""
    cfg = MODELS[model] or _configs(False)[1]
    m = HoverNeXt(cfg, **CONFIGS[name])
    m.fuse()
    key = {"k9": "k9", "heads": "k10", "pallas": "k11", "fused_decoder": "k7"}[name]
    assert key in m.fused_weights
    routes = []
    for call, geo in _kernel_tilings(cfg, name):
        assert geo.smem_bytes <= tdec.SMEM_PER_BLOCK, (call, geo)
        routes.append(geo.route)
        if geo.route == "any":
            assert geo.smem_bytes == (geo if isinstance(geo, tdec.DecoderConvTiling)
                                      else geo.any_geo).smem_bytes
        if geo.route == "wide":
            assert geo.smem_bytes == geo.head_geo.smem_bytes and geo.head_geo.fits
    if model == "nano_dec40":  # no width of (b) is one the kernels are compiled for
        # K8-K11 take the wide route (K10 and K11 with 17 head columns), K7 its any route
        assert routes[-1] == "wide" and set(routes[:-1]) <= {"any"}, routes
    if model == "nano" and name == "fused_decoder":  # only dec2.conv0 (skip 80) leaves them
        assert routes.count("any") == 1 and routes[4] == "any", routes
    if model == "nano" and name != "fused_decoder":  # decoder width 64, 10 head columns
        assert len(routes) == 1 and routes[0] != "any", routes


# K7 (cx, cs, cout) and K8-K11 (C, n_out) at the widths chip_smoke.py sweeps
K7_WIDTHS = [(192, 80, 96), (20, 12, 40), (640, 320, 320), (128, 0, 1024), (2816, 1408, 384)]
FINAL_WIDTHS = [(40, 10), (96, 17), (128, 33), (256, 17)]


@pytest.mark.parametrize("shape", K7_WIDTHS, ids=lambda s: "x".join(map(str, s)))
def test_k7_tiling_takes_the_widths_the_pallas_kernel_takes(shape):
    cx, cs, cout = shape
    geo = tdec.DecoderConvTiling(4, 16, 16, cx, cs, cout)
    assert geo.smem_bytes <= tdec.SMEM_PER_BLOCK
    fixed = cout in tdec.KERNEL_COUTS and not (cx % 32 or cs % 32)
    assert geo.route == ("fixed" if fixed else "any")
    assert geo.n_chunks * geo.n_tile >= cout and geo.raw == (cout > 384)
    assert geo.l2_bytes()["weights"] > 0


@pytest.mark.parametrize("width", FINAL_WIDTHS, ids=lambda s: f"C{s[0]}-n{s[1]}")
def test_final_tilings_take_the_widths_the_pallas_kernels_take(width):
    c, n_out = width
    tilings = [tdec.StripTiling(2, 64, 64, cin=c, cout=c),
               tdec.UpsampleTiling(2, 32, 32, cin=c, cout=c),
               tdec.UpsampleTiling(2, 32, 32, head=True, cin=c, cout=c, n_out=n_out),
               tdec.StripTiling(2, 32, 32, phases=4, cin=c, cout=c, n_out=n_out)]
    for geo in tilings:  # K8-K11 on the wide route (K8 and K9 with no head)
        head = geo is tilings[2] or geo is tilings[3]
        # K8 whose weights would stream takes K7's any route instead
        want = "any" if geo is tilings[0] and not geo.head_geo.resident else "wide"
        assert geo.route == want and geo.head_geo.head == head
        assert geo.smem_bytes <= tdec.SMEM_PER_BLOCK
        assert geo.any_geo.raw == (head or c > 384)
    # HoverNeXt-tiny's widths keep their own kernels; a full K11 head does not
    assert tdec.StripTiling(2, 64, 64).route == "conv64"
    assert tdec.UpsampleTiling(2, 32, 32, head=True, n_out=10).route == "upsample_conv"
    assert tdec.StripTiling(2, 32, 32, phases=4, n_out=10).route == "conv64"
    assert tdec.StripTiling(2, 32, 32, phases=4, n_out=10, block_diagonal=False).route == "wide"


@pytest.mark.parametrize("kernel", ["decoder_conv", "final_conv_gelu", "upsample_final",
                                    "final_heads", "composite_final_heads"])
def test_widths_past_the_limit_are_refused_naming_the_kernel(kernel):
    """A width past 1024 (the limit until the any route took every width)
    runs on the any route (K7) or the wide route (K8-K11, in N chunks of
    ``n_max`` columns); what is still refused names the kernel and its limit: a
    head's input past HEAD_MAX_WIDTH channels (its second pass stages a
    pixel's bf16 row in shared memory), no output channel elsewhere."""
    past = 1025
    make = {"decoder_conv": lambda c: tdec.DecoderConvTiling(1, 8, 8, 64, 0, c),
            "final_conv_gelu": lambda c: tdec.StripTiling(1, 32, 8, cin=c, cout=c),
            "upsample_final": lambda c: tdec.UpsampleTiling(1, 4, 4, cin=64, cout=c),
            "final_heads": lambda c: tdec.UpsampleTiling(1, 4, 4, head=True, cout=c),
            "composite_final_heads": lambda c: tdec.StripTiling(1, 4, 4, phases=4, cout=c)}
    geo = make[kernel](past)
    if kernel != "decoder_conv":
        assert len(geo.head_geo.n_chunks) == -(-past // geo.head_geo.n_max)
        # K8's weights (1025 x 1025) would stream: K7's any route takes it
        assert geo.route == ("any" if kernel == "final_conv_gelu" else "wide")
        assert geo.smem_bytes <= tdec.SMEM_PER_BLOCK
    else:
        assert geo.route == "any"
    any_geo = geo if kernel == "decoder_conv" else geo.any_geo
    assert any_geo.n_chunks == -(-any_geo.cout // 384) and any_geo.raw
    over = {"final_heads": tdec.HEAD_MAX_WIDTH + 1,
            "composite_final_heads": tdec.HEAD_MAX_WIDTH // 4 + 1}.get(kernel, 0)
    limit = "HEAD_MAX_WIDTH" if over else "cout >= 1"
    with pytest.raises(ValueError, match=f"{kernel} kernel takes.*{limit}"):
        make[kernel](over)


@pytest.mark.parametrize("kernel", ["final_heads", "composite_final_heads"])
def test_heads_with_no_column_are_refused_naming_the_kernel(kernel):
    """A head of no column (n_out 0) is refused at any width, naming the
    kernel and the bound it breaks."""
    make = {"final_heads": lambda: tdec.UpsampleTiling(1, 4, 4, head=True, n_out=0),
            "composite_final_heads": lambda: tdec.StripTiling(1, 4, 4, phases=4, n_out=0)}
    with pytest.raises(ValueError, match=f"{kernel} kernel takes.*n_out >= 1.*n_out 0"):
        make[kernel]()


def _n(rng, shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(20, 12, 40), (64, 48, 80)], ids=["20+12-40", "64+48-80"])
def test_k7_plain_matches_pallas_at_any_route_widths(shape):
    cx, cs, cout = shape
    rng = np.random.default_rng(cx + cs + cout)
    x, skip = _n(rng, (2, 10, 12, cx)), _n(rng, (2, 10, 12, cs))
    wk = _n(rng, (3, 3, cx + cs, cout), (9 * (cx + cs)) ** -0.5)
    b, g, lb = _n(rng, cout, 0.1), _n(rng, cout, 0.1, 1.0), _n(rng, cout, 0.1)
    ref = jdec.fused_decoder_conv(*map(jnp.asarray, (x, skip, wk, b, g, lb)), interpret=True)
    got = tdec.decoder_conv(*map(torch.from_numpy, (x, skip, wk, b, g, lb)))
    _assert_elementwise(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("kernel", ["k8", "k9", "k10_n17", "k11_n17", "k11_full_head",
                                    "k10_n33", "k11_n33"])
def test_final_plain_matches_pallas_at_c40(kernel):
    """K8-K11 at C = 40, K10/K11 with 17 and 33 head columns, and K11 with
    a head that is not block-diagonal (on the card all of them take the
    wide route)."""
    rng = np.random.default_rng({"k8": 40, "k9": 41, "k10_n17": 42, "k11_n17": 43,
                                 "k11_full_head": 44, "k10_n33": 45, "k11_n33": 46}[kernel])
    c, n_out = 40, 33 if kernel.endswith("n33") else 17
    T, J = torch.from_numpy, jnp.asarray
    w, b = _n(rng, (3, 3, c, c), (9 * c) ** -0.5), _n(rng, c, 0.1)
    if kernel == "k8":
        x = _n(rng, (1, 32, 12, c))
        ref = jdec.fused_final_conv_gelu(J(x), J(w), J(b), rows=32, interpret=True)
        got = tdec.final_conv_gelu(T(x), T(w), T(b))
    elif kernel == "k9":
        x = _n(rng, (2, 6, 10, c))
        ref = jdec.fused_upsample_final(J(x), J(w), J(b), interpret=True)
        got = tdec.upsample_final(T(x), T(w), T(b))
    elif kernel.startswith("k10"):
        x, wh, bh = _n(rng, (2, 6, 10, c)), _n(rng, (c, n_out), 0.3), _n(rng, n_out, 0.1)
        ref = jnp.transpose(jdec.fused_final_heads(*map(J, (x, w, b, wh, bh)), interpret=True),
                            (0, 2, 3, 1))
        got = tdec.final_heads(*map(T, (x, w, b, wh, bh)))
    else:
        p = _final_params(rng, c, c)
        p["head_tp"] = {"kernel": _n(rng, (1, 1, c, n_out - 4), 0.3),
                        "bias": _n(rng, n_out - 4, 0.1)}
        jp = jax.tree.map(J, p)
        wc, b4, wcat, bcat = jfn._lowres_head_weights(jp, jp["final_conv"], jnp.float32)
        wh, bh = _j_block_diag(wcat, bcat)
        if kernel == "k11_full_head":  # every block of the head nonzero
            wh = J(_n(rng, wh.shape, 0.1))
        x = _n(rng, (2, 9, 7, c))
        ref = jdec.composite_final_heads(J(x), wc, b4, wh, bh, interpret=True)
        got = tdec.composite_final_heads(T(x), *(T(np.array(a)) for a in (wc, b4, wh, bh)))
        assert got.shape[-1] == 4 * n_out
    _assert_elementwise(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_f32_forward_runs_its_convs_without_tf32(dtype):
    _, tcfg = _configs(False)
    model = HoverNeXt(tcfg).to(dtype).eval()
    seen = []
    for mod in (model.encoder.downsample_layers[0][0], model.final_conv, model.head_np):
        mod.register_forward_hook(lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            model(torch.zeros(1, 64, 64, 3))
        assert len(seen) == 3
        assert seen == [dtype != torch.float32] * 3
        assert torch.backends.cudnn.allow_tf32 is True  # restored
        assert torch.backends.cuda.matmul.allow_tf32 is False  # torch's default, left alone
    finally:
        torch.backends.cudnn.allow_tf32 = prev
