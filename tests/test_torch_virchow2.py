"""The port's timm Virchow2 tower against the JAX package's on the CPU, at
``tests/test_virchow2_parity.py``'s ``ARGS`` (width 64, 3 layers, 2 heads,
patch 14, image 56, 4 registers) in both variants (SwiGLU + LayerScale +
``patches_only``; GELU, no LayerScale, ``prefix``), on the same variables
(the JAX model's tree, drawn from a seed) carried across by
``timm_state_dict_from_jax``: f32 within atol 5e-5 / rtol 1e-4, bf16
against the jitted JAX bf16 forward at cosine >= 0.999 a tile. The layout
test and the config inference equal JAX's; JAX's ``convert_timm_vit``
consumes the port's ``state_dict()`` whole; the loaders load strict;
``run_extract_features`` with the tower equals JAX's (atol 5e-4 / rtol
1e-3, "Virchow2" recorded, the Virchow2 batch clamp); ``cli.main
--weights`` runs a converted timm artifact; and a tower wider than the text
tower fails at step 4 in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.core.checkpoints import save_converted
from path_gene_multimodal_tpu.io.slide import synthetic_wsi
from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.models.vit_timm import TimmViT as JTimmViT
from path_gene_multimodal_tpu.models.vit_timm import TimmViTConfig as JTimmViTConfig
from path_gene_multimodal_tpu.models.weights import convert_timm_vit as j_convert
from path_gene_multimodal_tpu.models.weights import infer_timm_vit_config as j_infer
from path_gene_multimodal_tpu.models.weights import is_timm_vit_layout as j_is_timm
from path_gene_multimodal_tpu.pipeline import embed as jembed
from path_gene_multimodal_tpu_torch.cli import main as tcli
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.core.artifacts import read_features_h5, read_tessellation_h5
from path_gene_multimodal_tpu_torch.core.checkpoints import load_converted, load_virchow2_from_torch
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide
from path_gene_multimodal_tpu_torch.models.clip import IMAGENET_MEAN, IMAGENET_STD, ImageEncoder
from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViT, TimmViTConfig
from path_gene_multimodal_tpu_torch.models.weights_vit_timm import (
    infer_timm_vit_config,
    is_timm_vit_layout,
    timm_state_dict_from_jax,
)
from path_gene_multimodal_tpu_torch.pipeline import embed as tembed

F32_ATOL, F32_RTOL = 5e-5, 1e-4
ATOL, RTOL = 5e-4, 1e-3
MIN_COS = 0.999
ARGS = dict(image_size=56, patch_size=14, width=64, layers=3, heads=2, num_registers=4)
VARIANTS = {
    "swiglu": dict(mlp_hidden=384),
    "gelu_prefix": dict(mlp_hidden=192, mlp_type="gelu", use_layerscale=False,
                        pos_embed_mode="prefix"),
}
TEXT = dict(vocab_size=49408, context_length=77, width=32, layers=1, heads=2, out_dim=128)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_variables(jcfg, seed=0):
    """Variables of the JAX ``TimmViT``'s tree (shapes from ``jax.eval_shape``
    of flax's init), drawn with numpy: kernels N(0, 1 / fan_in), LayerNorm
    scales N(1, 0.02), LayerScale gammas N(0.1, 0.02), the rest N(0, 0.02)."""
    shapes = jax.eval_shape(JTimmViT(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)))
    rng = np.random.default_rng(seed)

    def draw(kp, leaf):
        name, shape = str(kp[-1]), leaf.shape
        if "kernel" in name:
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif "scale" in name:
            a = rng.normal(1, 0.02, shape)
        elif "gamma" in name:
            a = rng.normal(0.1, 0.02, shape)
        else:
            a = rng.normal(0, 0.02, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def tower(request):
    kw = dict(ARGS, **VARIANTS[request.param])
    jcfg, tcfg = JTimmViTConfig(**kw), TimmViTConfig(**kw)
    v = _jax_variables(jcfg)
    return jcfg, tcfg, v, timm_state_dict_from_jax(v, tcfg)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(1).normal(size=(3, 56, 56, 3)).astype(np.float32)


def _port(tcfg, sd, dtype):
    net = TimmViT(tcfg, dtype)
    net.load_state_dict(sd, strict=True)
    return net.eval()


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_timm_vit_matches_jax(tower, pixels):
    jcfg, tcfg, v, sd = tower
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jax.jit(JTimmViT(jcfg, dtype=jd).apply)(v, jnp.asarray(pixels))
                         .astype(jnp.float32))
        with torch.no_grad():
            out = _port(tcfg, sd, td)(torch.from_numpy(pixels))
        assert out.dtype == td and out.shape == (3, tcfg.out_width)
        got = out.float().numpy()
        if td == torch.float32:
            np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=F32_RTOL)
        else:
            assert _cos(got, ref).min() >= MIN_COS


def test_layout_and_config_inference_match_jax(tower):
    _, tcfg, _, sd = tower
    npsd = {k: t.numpy() for k, t in sd.items()}
    assert is_timm_vit_layout(npsd) and j_is_timm(npsd)
    clip_like = {"visual.conv1.weight": np.zeros((8, 3, 14, 14)), "blocks.0.attn.qkv.weight": 0}
    assert not is_timm_vit_layout(clip_like) and not j_is_timm(clip_like)
    got, ref = infer_timm_vit_config(npsd), j_infer(npsd)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    # heads are not in the shapes: both fall back to width // 64
    assert got == dataclasses.replace(tcfg, heads=1)


def test_jax_converter_consumes_port_state_dict(tower):
    jcfg, _, v, sd = tower
    npsd = {k: t.numpy() for k, t in TimmViT(TimmViTConfig(**dataclasses.asdict(jcfg)))
            .state_dict().items()}
    assert set(npsd) == set(sd)
    cfg, back, leftover = j_convert({k: t.numpy() for k, t in sd.items()}, jcfg)
    assert leftover == {} and cfg == jcfg
    jax.tree.map(np.testing.assert_array_equal, back, v)


def test_load_virchow2_from_torch_strict(tower, tmp_path):
    _, tcfg, _, sd = tower
    torch.save({f"module.{k}": t for k, t in sd.items()}, tmp_path / "virchow2.pt")
    cfg, got = load_virchow2_from_torch(tmp_path / "virchow2.pt")
    assert cfg == dataclasses.replace(tcfg, heads=1)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    bad = dict(sd, **{"head.weight": torch.zeros(5, 64)})
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="head.weight"):
        load_virchow2_from_torch(tmp_path / "bad.pt")


def test_load_converted_reads_timm_kind(tower, tmp_path):
    jcfg, tcfg, v, sd = tower
    path = save_converted("virchow2", jcfg, v, tmp_path / "v2")
    kind, cfg, params = load_converted(path)
    assert kind == "virchow2" and cfg == tcfg
    got = timm_state_dict_from_jax(params, cfg)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def slides():
    js = synthetic_wsi(640, 480, seed=9, n_blobs=2, nuclei_per_blob=20)
    return js, ArraySlide(js._levels[0], mpp=js.mpp)


class _Spy:
    """An encoder that records the batch sizes it is called with."""

    def __init__(self, enc):
        self.enc, self.batches = enc, []

    def __getattr__(self, name):
        return getattr(self.enc, name)

    def __call__(self, tiles):
        self.batches.append(len(tiles))
        return self.enc(tiles)


def test_run_extract_features_matches_jax(slides, tmp_path):
    js, ts = slides
    kw = dict(ARGS, **VARIANTS["swiglu"])
    jcfg, tcfg = JTimmViTConfig(**kw), TimmViTConfig(**kw)
    v = _jax_variables(jcfg, seed=2)
    cfgs = []
    for c in (j_default_config(), default_config()):
        cfgs.append(c.replace(patch_size=56, embedding=dataclasses.replace(
            c.embedding, batch_size=100, virchow2_batch_size=8, dtype="float32")))
    coords = np.stack(np.meshgrid(np.arange(0, 600, 56), np.arange(0, 440, 56)),
                      -1).reshape(-1, 2).astype(np.int64)[:21]
    jenc = jclip.ImageEncoder(jcfg, params=v, dtype=jnp.float32, mean=jclip.IMAGENET_MEAN,
                              std=jclip.IMAGENET_STD)
    tenc = _Spy(ImageEncoder(tcfg, state_dict=timm_state_dict_from_jax(v, tcfg),
                             dtype=torch.float32, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                             device="cpu"))
    ref = jembed.run_extract_features(js, coords, jenc, tmp_path / "j", "s", cfgs[0])
    got = tembed.run_extract_features(ts, coords, tenc, tmp_path / "t", "s", cfgs[1])
    assert got.shape == (21, 128) and tenc.batches == [8, 8, 8]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    h5 = read_features_h5(tmp_path / "t" / "s_features.h5")
    assert h5["attrs"]["model_type"] == "Virchow2" and h5["features"].shape == (21, 128)
    np.testing.assert_array_equal(h5["features"], got)


def test_wider_tower_than_text_fails_at_annotation_in_both():
    feats = np.ones((3, 128), np.float32)
    classes = np.ones((2, 32), np.float32)
    with pytest.raises(TypeError):
        jembed.run_annotation(feats, classes, ["a", "b"], None, "s", write_artifacts=False)
    with pytest.raises(RuntimeError):
        tembed.run_annotation(feats, classes, ["a", "b"], None, "s", write_artifacts=False,
                              device="cpu")


def test_cli_main_takes_timm_artifact(tmp_path, monkeypatch):
    js = synthetic_wsi(1792, 1344, seed=13, n_blobs=4, nuclei_per_blob=40)  # the runner tests'
    ts = ArraySlide(js._levels[0], mpp=js.mpp)
    kw = dict(ARGS, **VARIANTS["swiglu"])
    jcfg, tcfg = JTimmViTConfig(**kw), TimmViTConfig(**kw)
    v = _jax_variables(jcfg, seed=3)
    wpath = save_converted("virchow2", jcfg, v, tmp_path / "v2.npz")
    jtext = jclip.TextConfig(**TEXT)
    tparams = jclip.TextTower(jtext).init(jax.random.PRNGKey(1), jnp.zeros((1, 77), jnp.int32))
    save_converted("clip_text", jtext, tparams, tmp_path / "v2_text.npz")
    base = default_config()
    cfg = base.replace(
        embedding=dataclasses.replace(base.embedding, batch_size=16, dtype="float32"),
        polygon=dataclasses.replace(base.polygon, min_polygon_area_px=0, area_min_tiles=1),
        tme_classes=base.classes)
    monkeypatch.setattr(tcli, "default_config", lambda **k: cfg)
    for var in ("PGM_CLIP_BPE", "PGM_CLIP_VOCAB_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hub"))
    slide = js.save(tmp_path / "case.npz")
    out = tmp_path / "out" / "case"
    assert tcli.main(["--wsi", str(slide), "--outroot", str(tmp_path / "out"), "--weights",
                      str(wpath), "--device", "cpu", "--no-locks"]) == 0
    h5 = read_features_h5(out / "case_features.h5")
    assert h5["attrs"]["model_type"] == "Virchow2" and h5["features"].shape[1] == 128
    coords = read_tessellation_h5(out / "case.h5")["coords"]
    enc = ImageEncoder(tcfg, state_dict=timm_state_dict_from_jax(v, tcfg), dtype=torch.float32,
                       mean=IMAGENET_MEAN, std=IMAGENET_STD, device="cpu")
    direct = tembed.run_extract_features(ts, coords, enc, tmp_path / "d", "case", cfg,
                                         write_artifacts=False)
    np.testing.assert_allclose(h5["features"], direct, atol=1e-6, rtol=1e-6)
    assert (out / "case.geojson").exists()
