"""The published hover_next layout in the port against the JAX package's, on
the CPU: the seeded state dict, the key normaliser and the weight carry-over
(``models/weights_hovernext_real.py``), the forward (``models/
hovernext_real.py``) in f32 and bf16, the align-corners upsample, both
instance decoders (``ops/watershed.py``), the rotation TTA and
``RealNucleiModel`` through both nuclei modes, and the CLI.

The layout tests run at depths (1, 1, 1, 1), dims (8, 16, 32, 64),
decoder (16, 8, 8, 8). The model-level tests fit their heads with
``chip_smoke._fit_real_heads`` and need wider features for the fit to find
nuclei: dims (32, 32, 64, 64), decoder (32, 32, 32, 32), 128-px input. The
JAX side takes its XLA paths (no TPU), the port its kernels' plain
versions."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.io.slide import synthetic_wsi as j_synthetic_wsi
from path_gene_multimodal_tpu.models import weights_hovernext_real as jw
from path_gene_multimodal_tpu.models.hovernext_real import RealHoverNeXt as JRealHoverNeXt
from path_gene_multimodal_tpu.models.hovernext_real import (
    upsample_bilinear_align_corners as j_upsample,
)
from path_gene_multimodal_tpu.ops import watershed as jws
from path_gene_multimodal_tpu.ops.instances import compact_labels_device
from path_gene_multimodal_tpu.pipeline import nuclei as jnuc
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, RealHoverNeXtConfig, default_config
from path_gene_multimodal_tpu_torch.io.slide import synthetic_wsi
from path_gene_multimodal_tpu_torch.models import weights_hovernext_real as tw
from path_gene_multimodal_tpu_torch.models.hovernext_real import (
    RealHoverNeXt,
    init_weights,
    upsample_bilinear_align_corners,
)
from path_gene_multimodal_tpu_torch.ops import watershed as tws
from path_gene_multimodal_tpu_torch.ops.components import INF
from path_gene_multimodal_tpu_torch.pipeline import nuclei as tnuc

DEPTHS, DIMS, DEC = (1, 1, 1, 1), (8, 16, 32, 64), (16, 8, 8, 8)
FIT_DIMS, FIT_DEC, SIZE, TILE = (32, 32, 64, 64), (32, 32, 32, 32), 128, 112
ATOL, RTOL, MIN_COS = 5e-4, 1e-3, 0.999


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = prev


def _synth(branches=None, seed=0):
    return tw.synthesize_real_state_dict(DEPTHS, DIMS, DEC, branches, seed=seed)


def _port_model(sd_np, dtype=torch.float32):
    """(config, model) of a published-layout numpy state dict, loaded strict."""
    cfg, sd = tw.normalize_real_state_dict(sd_np)
    net = RealHoverNeXt(cfg)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return cfg, net.to(dtype).eval()


def _same_config(tcfg, jcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def _torch_to_np(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


# -- the layout ------------------------------------------------------------------


@pytest.mark.parametrize("branches", [{"inst": 5, "ct": 6}, {"inst": 3, "ct": 6}],
                         ids=["inst5", "inst3"])
def test_synthesize_real_state_dict_matches_jax(branches):
    """Byte-equal arrays in the same key order; the keys are exactly
    ``RealHoverNeXt``'s ``state_dict()``; the JAX converter consumes all of
    them; the inferred config is JAX's."""
    t_sd, j_sd = _synth(branches, seed=3), jw.synthesize_real_state_dict(
        DEPTHS, DIMS, DEC, branches, seed=3)
    assert list(t_sd) == list(j_sd)
    for k in j_sd:
        assert t_sd[k].dtype == j_sd[k].dtype and t_sd[k].tobytes() == j_sd[k].tobytes(), k
    cfg, norm = tw.normalize_real_state_dict(t_sd)
    assert list(norm) == list(t_sd)
    assert set(RealHoverNeXt(cfg).state_dict()) == set(t_sd)
    jcfg, _, leftover = jw.convert_real_hovernext(t_sd)
    assert leftover == {}
    _same_config(cfg, jcfg)
    _same_config(tw.infer_real_config(t_sd), jw.infer_real_config(j_sd))


def test_real_state_dict_from_jax_round_trip():
    """JAX params → the port's state dict → the JAX converter gives the same
    params back; the state dict equals the seeded one it came from."""
    t_sd = _synth()
    cfg, norm = tw.normalize_real_state_dict(t_sd)
    jcfg, variables, _ = jw.convert_real_hovernext(t_sd)
    variables = jax.tree.map(np.asarray, variables)
    sd = tw.real_state_dict_from_jax(variables, cfg)
    assert set(sd) == set(RealHoverNeXt(cfg).state_dict())
    for k, v in sd.items():
        assert v.dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32)
        np.testing.assert_array_equal(v.numpy(), norm[k], err_msg=k)
    _, back, leftover = jw.convert_real_hovernext(_torch_to_np(sd), jcfg)
    assert leftover == {}
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


def _fcmae(sd):
    """The encoder re-keyed to the official FCMAE naming under ``encoder.``."""
    import re

    subs = ((r"stem\.(\d)\.", r"downsample_layers.0.\1."),
            (r"stages\.(\d+)\.downsample\.(\d)\.", r"downsample_layers.\1.\2."),
            (r"stages\.(\d+)\.blocks\.(\d+)\.", r"stages.\1.\2."),
            (r"conv_dw", "dwconv"), (r"mlp\.fc1", "pwconv1"), (r"mlp\.fc2", "pwconv2"),
            (r"mlp\.grn\.weight", "grn.gamma"), (r"mlp\.grn\.bias", "grn.beta"))
    out = {}
    for k, v in sd.items():
        if k.startswith("encoder.model."):
            k = k[len("encoder.model."):]
            for a, b in subs:
                k = re.sub(a, b, k)
            if ".grn." in k:
                v = v.reshape(1, 1, 1, -1)
            k = "encoder." + k
        out[k] = v
    return out


def _shared_prefixed(sd):
    """One decoder shared by two heads, the whole dict under ``module.``."""
    sd = {k.replace("decoder_inst", "decoder"): v for k, v in sd.items()}
    rng = np.random.default_rng(9)
    sd["head_tc.0.weight"] = (rng.standard_normal((7, DEC[-1], 3, 3)) * 0.1).astype(np.float32)
    sd["head_tc.0.bias"] = (rng.standard_normal(7) * 0.1).astype(np.float32)
    return {f"module.{k}": v for k, v in sd.items()}


CASES = {
    "inst5": (lambda: _synth(), 64),
    "inst5_256px": (lambda: _synth(), 256),
    "inst3": (lambda: _synth({"inst": 3, "ct": 6}, seed=1), 96),
    "shared_decoder_module_prefix": (lambda: _shared_prefixed(_synth({"inst": 3}, seed=2)), 64),
    "fcmae_encoder": (lambda: _fcmae(_synth(seed=4)), 64),
    "bare_encoder": (lambda: {k.replace("encoder.model.", "encoder."): v
                              for k, v in _synth(seed=5).items()}, 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_f32_matches_flax(case):
    """The f32 forward of every naming the loader takes equals the flax
    ``RealHoverNeXt`` given the JAX converter's params, head for head, with
    the seeded (non-identity) BatchNorm statistics."""
    make, px = CASES[case]
    sd = make()
    jcfg, variables, leftover = jw.convert_real_hovernext(sd)
    assert leftover == {}
    cfg, net = _port_model(sd)
    _same_config(cfg, jcfg)
    if case == "shared_decoder_module_prefix":
        assert {d for d, _, _ in cfg.branches} == {"decoder"}
        assert len([m for m in net.children()]) == 4  # encoder, one decoder, two heads
    x = np.random.default_rng(0).uniform(0, 1, (2, px, px, 3)).astype(np.float32)
    want = jax.jit(JRealHoverNeXt(jcfg, dtype=jnp.float32).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == torch.float32 and got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_forward_bf16_cosine_vs_flax():
    """The bf16 forward against flax's bf16 forward: cosine >= 0.999 a head;
    BatchNorm's statistics stay f32 in the bf16 model."""
    sd = _synth()
    jcfg, variables, _ = jw.convert_real_hovernext(sd)
    _, net = _port_model(sd, torch.bfloat16)
    bn = net.decoder_inst.blocks[0].conv1[1]
    assert bn.running_var.dtype == bn.weight.dtype == torch.float32
    assert net.decoder_inst.blocks[0].conv1[0].weight.dtype == torch.bfloat16
    x = np.random.default_rng(1).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    want = jax.jit(JRealHoverNeXt(jcfg, dtype=jnp.bfloat16).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for name in want:
        a, b = got[name].numpy().ravel(), np.asarray(want[name]).ravel()
        assert got[name].dtype == torch.float32
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= MIN_COS, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_align_corners_matches_jax(dtype):
    """Equal to the JAX package's function (f32 and bf16), and in f32 to
    ``F.interpolate(..., align_corners=True)``."""
    x = np.random.default_rng(3).normal(size=(2, 7, 9, 4)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = upsample_bilinear_align_corners(tx, 2)
    want = j_upsample(jnp.asarray(x).astype(getattr(jnp, dtype)), 2)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    if dtype == "float32":
        ref = torch.nn.functional.interpolate(tx.permute(0, 3, 1, 2), scale_factor=2,
                                              mode="bilinear", align_corners=True)
        np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_infer_convnext_config_routes_timm_naming():
    """``weights_convnext.infer_convnext_config`` reads timm's names through
    ``infer_convnext_config_timm`` (JAX ``core/checkpoints.py:214-224``)."""
    from path_gene_multimodal_tpu_torch.models.weights_convnext import infer_convnext_config

    sub = {k[len("encoder.model."):]: v for k, v in _synth().items()
           if k.startswith("encoder.model.")}
    want = jw.infer_convnext_config_timm(sub)
    for got in (infer_convnext_config(sub), tw.infer_convnext_config_timm(sub)):
        assert got == ConvNeXtConfig(depths=want.depths, dims=want.dims) == \
            ConvNeXtConfig(depths=DEPTHS, dims=DIMS)


# -- the fitted small model: decoders, TTA, both nuclei modes, the CLI --------------


@pytest.fixture(scope="module")
def fitted():
    """A byte-identical slide from both packages, and for a 5- and a
    3-channel instance head: the port's config and head-fitted state dict
    (seeded weights, seeded BatchNorm statistics), and JAX's config and
    params from its own converter of that state dict."""
    import chip_smoke

    tslide = synthetic_wsi(1024, 1024, seed=3, n_blobs=4, nuclei_per_blob=120)
    jslide = j_synthetic_wsi(1024, 1024, seed=3, n_blobs=4, nuclei_per_blob=120)
    assert np.array_equal(jslide._levels[0], tslide._levels[0])
    from path_gene_multimodal_tpu_torch.utils.headfit import sample_tissue_tiles

    tiles = sample_tissue_tiles(tslide, 6, SIZE, seed=1)
    models = {}
    for inst in (5, 3):
        cfg = RealHoverNeXtConfig(
            encoder=ConvNeXtConfig(depths=DEPTHS, dims=FIT_DIMS), decoder_channels=FIT_DEC,
            branches=(("decoder_inst", "head_inst", inst), ("decoder_ct", "head_ct", 6)),
            input_size=SIZE)
        net = RealHoverNeXt(cfg)
        init_weights(net, torch.Generator().manual_seed(inst), bn_stats=True)
        sd = chip_smoke._fit_real_heads(cfg, net.state_dict(), tiles, dtype=torch.float32,
                                        device="cpu")
        sd = {k: v.detach().clone() for k, v in sd.items()}
        jcfg, variables, leftover = jw.convert_real_hovernext(_torch_to_np(sd))
        assert leftover == {}
        jcfg = dataclasses.replace(jcfg, input_size=SIZE)
        models[inst] = (cfg, sd, jcfg, jax.tree.map(np.asarray, variables))
    return tslide, jslide, models


@pytest.fixture(scope="module")
def nuclei_models(fitted):
    """Both packages' f32 ``RealNucleiModel`` a head, built once: the JAX
    model's jitted programs then compile once for the tests' 4 x 128² batches."""
    out = {}
    for inst, (cfg, sd, jcfg, variables) in fitted[2].items():
        jm = jnuc.RealNucleiModel.build(jcfg, params=variables, dtype=jnp.float32, tta=4,
                                        max_instances=128)
        tm = tnuc.RealNucleiModel.build(cfg, state_dict=sd, dtype=torch.float32, tta=4,
                                        device="cpu", max_instances=128)
        out[inst] = (jm, tm)
    return out


def _eval_tiles(fitted, n=4, seed=7):
    from path_gene_multimodal_tpu_torch.utils.headfit import sample_tissue_tiles

    return sample_tissue_tiles(fitted[0], n, SIZE, seed=seed)


def test_tta_forward_real_matches_jax(fitted):
    """``_tta_forward_real`` with the 5-channel head's HV channels marked
    (the rot-90 swap and signs) equals JAX's on the same params; a mutant
    with the HV channels left unmarked must differ from it."""
    _, _, models = fitted
    cfg, sd, jcfg, variables = models[5]
    tiles = _eval_tiles(fitted, 2).astype(np.float32) / 255.0
    jmodel = JRealHoverNeXt(jcfg, dtype=jnp.float32)
    hv = {"head_inst": (3, 5)}
    want = jnuc._tta_forward_real(jax.jit(jmodel.apply), variables, jnp.asarray(tiles), tta=4,
                                  hv_heads=hv)
    net = RealHoverNeXt(cfg)
    net.load_state_dict(sd)
    with torch.no_grad():
        got = tnuc._tta_forward_real(net.eval(), torch.from_numpy(tiles), tta=4, hv_heads=hv)
        plain = tnuc._tta_forward_real(net, torch.from_numpy(tiles), tta=4)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    swapped = np.abs(plain["head_inst"][..., 3:5].numpy() - np.asarray(want["head_inst"])[..., 3:5])
    assert swapped.max() > 100 * ATOL


def _touching_logits():
    """JAX's touching-nuclei case (tests/test_hovernext_real_parity.py:288):
    two disks meeting on a border-class ridge."""
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    d1, d2 = np.hypot(yy - 32, xx - 22), np.hypot(yy - 32, xx - 42)
    fg = (d1 < 9) | (d2 < 9)
    border = fg & (np.abs(d1 - d2) < 2.5)
    cls = np.zeros((h, w), np.int64)
    cls[border] = 2
    cls[fg & ~border] = 1
    return (np.eye(3, dtype=np.float32)[cls] * 10.0)[None]


def _fitted_logits(fitted, nuclei_models, inst):
    jm, _ = nuclei_models[inst]
    inst_logits, _ = jm._infer(jm.params, jnp.asarray(_eval_tiles(fitted)))
    return np.array(inst_logits)


@pytest.mark.parametrize("case", ["touching", "threeclass_fitted", "hover_fitted"])
def test_instance_decoders_match_jax(fitted, nuclei_models, case, monkeypatch):
    """On identical logits, ``threeclass_instances_batch`` and the split
    ``hover_instances_batch`` (as ``RealNucleiModel`` calls it on a
    5-channel head) give labels identical to JAX's XLA route +
    ``compact_labels_device``; the flood's round cap (64 in XLA, 65 in the
    port) does not bind on these maps."""
    logits = _touching_logits() if case == "touching" else \
        _fitted_logits(fitted, nuclei_models, 5 if case == "hover_fitted" else 3)
    tl = torch.from_numpy(logits)
    if case == "hover_fitted":
        p3 = jax.nn.softmax(jnp.asarray(logits[..., :3]), axis=-1)
        jl = jws.hover_instances_batch(p3[..., 1] + p3[..., 2], jnp.asarray(logits[..., 3:5]))
        q3 = torch.softmax(tl[..., :3], dim=-1)
        got, n_over = tws.hover_instances_batch(q3[..., 1] + q3[..., 2], tl[..., 3:5])
    else:
        jl = jws.threeclass_instances_batch(jnp.asarray(logits))
        got, n_over = tws.threeclass_instances_batch(tl)
    want = np.asarray(compact_labels_device(jl)).astype(np.int32)
    got = torch.where(got < INF, got, 0).numpy()
    assert int(n_over[0]) == 0 and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "touching":
        assert set(np.unique(got)) == {0, 1, 2}
    else:
        assert (got.max(axis=(1, 2)) > 0).all()
    if case == "threeclass_fitted":  # uncapped, the plain flood gives the same labels
        from path_gene_multimodal_tpu_torch.ops import flood

        flood_calls = []
        monkeypatch.setattr(tws, "marker_watershed", lambda *a, **k: flood_calls.append(1) or
                            flood.marker_watershed_plain(*a, levels=k["levels"],
                                                         max_rounds=100_000))
        uncapped, _ = tws.threeclass_instances_batch(tl)
        assert flood_calls == [1]
        np.testing.assert_array_equal(torch.where(uncapped < INF, uncapped, 0).numpy(), got)


def _annotations(fitted, path):
    jslide = fitted[1]
    coords = [(x, y) for y in range(0, 1024 - TILE, TILE) for x in range(0, 1024 - TILE, TILE)]
    keep = [(x, y) for x, y in coords
            if (jslide._levels[0][y: y + TILE, x: x + TILE] != 243).mean() > 0.5][:6]
    assert len(keep) >= 4
    cls = list(j_default_config().classes)[0]
    pd.DataFrame([{"tile_index": i, "x": x, "y": y, "predicted_class": cls, "in_tme_roi": True}
                  for i, (x, y) in enumerate(keep)]).to_csv(path, index=False)
    return path


def test_real_nuclei_model_tiles_table_matches_jax(fitted, nuclei_models, tmp_path):
    """The per-tile mode with the fitted f32 5-channel model of both
    packages: the tables meet the canonical model's row-for-row bar."""
    from test_torch_nuclei_slice import _assert_tables_match

    ann = _annotations(fitted, tmp_path / "s_annotations_with_coords.csv")
    jm, tm = nuclei_models[5]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jt = jnuc.run_hovernet_pipeline_on_wsi_tiles(
        fitted[1], ann, tmp_path / "j", "s", jm, j_default_config(patch_size=TILE), batch_size=4)
    tt = tnuc.run_hovernet_pipeline_on_wsi_tiles(
        fitted[0], ann, tmp_path / "t", "s", tm, default_config(patch_size=TILE), batch_size=4)
    assert tt.attrs["cc_slot_overflow_tiles"] == 0
    _assert_tables_match(jt, tt)
    assert set(tt["type"]) <= {1, 2, 3, 4, 5}


def test_real_nuclei_model_wsi_table_matches_jax(fitted, nuclei_models, tmp_path):
    """The sliding-window mode with the fitted f32 3-channel model of both
    packages on a 380² crop with tissue (16 windows of 128 at stride 124):
    the tables row for row, in order, and the instance maps equal."""
    from path_gene_multimodal_tpu.io.slide import ArraySlide as JArraySlide
    from path_gene_multimodal_tpu.pipeline import nuclei_wsi as jnw
    from path_gene_multimodal_tpu_torch.io.slide import ArraySlide
    from path_gene_multimodal_tpu_torch.pipeline import nuclei_wsi as tnw
    from test_torch_nuclei_wsi import assert_maps_match, assert_wsi_tables_match

    lv = fitted[1]._levels[0]
    side = 380
    starts = range(0, lv.shape[0] - side, 64)
    y0, x0 = max(((y, x) for y in starts for x in starts),
                 key=lambda p: (lv[p[0]: p[0] + side, p[1]: p[1] + side] != 243).mean())
    crop = np.ascontiguousarray(lv[y0: y0 + side, x0: x0 + side])
    jm, tm = nuclei_models[3]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    _, jt = jnw.run_hovernext_wsi(JArraySlide(crop), jdir, "c", jm, j_default_config(),
                                  batch_size=4)
    _, tt = tnw.run_hovernext_wsi(ArraySlide(crop), tdir, "c", tm, default_config(),
                                  batch_size=4)
    assert len(tt) > 20
    assert_wsi_tables_match(jt, tt, jdir, tdir)
    m = assert_maps_match(jdir, tdir, "c")
    assert set(np.unique(m)) == set(range(len(tt) + 1))


@pytest.mark.parametrize("form", ["pt", "npz"])
def test_cli_real_checkpoint_matches_jax_cli(fitted, tmp_path, form, monkeypatch):
    """``hovernext_infer --device cpu --checkpoint`` on the fitted 5-channel
    model saved as a published-layout ``.pt`` (wrapped in ``state_dict``),
    or as the JAX package's ``save_converted`` ``.npz``, writes the table the
    JAX CLI writes from the ``.pt`` (one 256² window; the WSI tables' bar,
    and the same map). Both CLIs build their
    model in bf16, where the jitted JAX forward keeps intermediates in f32;
    here each package's ``RealNucleiModel.build`` is held at f32 so the
    tables can be compared row for row."""
    from path_gene_multimodal_tpu.cli import hovernext_infer as jcli
    from path_gene_multimodal_tpu.core.checkpoints import save_converted
    from path_gene_multimodal_tpu_torch.cli import hovernext_infer as tcli
    from test_torch_nuclei_wsi import assert_maps_match, assert_wsi_tables_match

    built = []
    for mod, f32 in ((jnuc, jnp.float32), (tnuc, torch.float32)):
        real = mod.RealNucleiModel.build.__func__

        def build(cls, *a, _real=real, _f32=f32, **k):
            built.append(cls)
            return _real(cls, *a, **dict(k, dtype=_f32))

        monkeypatch.setattr(mod.RealNucleiModel, "build", classmethod(build))
    _, _, models = fitted
    cfg, sd, jcfg, variables = models[5]
    pt = tmp_path / "real.pt"
    torch.save({"state_dict": sd}, pt)
    ck = pt if form == "pt" else save_converted("hovernext", jcfg, variables,
                                                tmp_path / "real.npz")
    one = tmp_path / "one.npy"
    np.save(one, fitted[1]._levels[0][384:640, 384:640])
    tables = []
    for main, ckpt, extra in ((jcli.main, pt, []), (tcli.main, ck, ["--device", "cpu"])):
        out = tmp_path / ("j" if main is jcli.main else "t")
        assert main(["--input", str(one), "--output", str(out), "--batch-size", "1",
                     "--checkpoint", str(ckpt), *extra]) == 0
        df = pd.read_parquet(out / "one_hovernet_nuclei_wsi.parquet")
        for col in df.columns:  # parquet gives list cells back as arrays
            if df[col].dtype == object and isinstance(df[col].iloc[0], np.ndarray):
                df[col] = [np.stack(v).tolist() if v.dtype == object else v.tolist()
                           for v in df[col]]
        tables.append(df)
    assert built == [jnuc.RealNucleiModel, tnuc.RealNucleiModel]
    assert len(tables[1]) > 20
    assert_wsi_tables_match(*tables, tmp_path / "j", tmp_path / "t")
    assert_maps_match(tmp_path / "j", tmp_path / "t", "one")


def test_cli_real_checkpoint_dp_equals_run_without_dp(fitted, tmp_path):
    """``hovernext_infer --dp --device cpu`` with the published layout (the
    fitted 5-channel model as a ``.pt``, bf16) over 8 CPU shards on one
    256² window: the table and the map of the run without ``--dp``."""
    from path_gene_multimodal_tpu_torch.cli import hovernext_infer as tcli
    from test_torch_hovernext_infer import _cpu_shards
    from test_torch_nuclei_wsi import assert_maps_match

    cfg, sd, _, _ = fitted[2][5]
    pt = tmp_path / "real.pt"
    torch.save({"state_dict": sd}, pt)
    one = tmp_path / "one.npy"
    np.save(one, fitted[0]._levels[0][384:640, 384:640])
    tables = []
    for out, dp in ((tmp_path / "one", []), (tmp_path / "dp", ["--dp"])):
        with _cpu_shards(8) as built:
            assert tcli.main(["--input", str(one), "--output", str(out), "--batch-size", "8",
                              "--checkpoint", str(pt), "--device", "cpu", *dp]) == 0
        assert [m.size for m in built] == ([8] if dp else [])
        tables.append(pd.read_parquet(out / "one_hovernet_nuclei_wsi.parquet")
                      .drop(columns=["nuc_id", "tile_path"]))
    assert len(tables[0]) > 20
    pd.testing.assert_frame_equal(tables[1], tables[0])
    assert_maps_match(tmp_path / "one", tmp_path / "dp", "one")


def test_real_nuclei_model_build_needs_the_card():
    """No fallback: without a card ``device="cuda"`` (the default) raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    cfg, _ = tw.normalize_real_state_dict(_synth())
    with pytest.raises((RuntimeError, AssertionError)):
        tnuc.RealNucleiModel.build(cfg)
