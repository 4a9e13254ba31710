"""The port's embed stage against the JAX package's on the CPU:
``iter_tile_batches`` (tiles and ``valid``, with and without prefetch),
``run_extract_features`` (f32 within atol 5e-4 / rtol 1e-3, bf16 cosine
>= 0.999 per tile, the empty slide, the Virchow2 batch clamp) and the
features H5 (``read_features_h5`` of either package reads either's file),
with the ``.npy`` and ``.pt`` sidecars."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.config import EmbeddingConfig as JEmbeddingConfig
from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.core.artifacts import read_features_h5 as j_read_features_h5
from path_gene_multimodal_tpu.io.slide import ArraySlide as JArraySlide
from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.pipeline import tessellate as jtess
from path_gene_multimodal_tpu.pipeline.embed import run_extract_features as j_run
from path_gene_multimodal_tpu_torch.config import EmbeddingConfig, default_config
from path_gene_multimodal_tpu_torch.core.artifacts import read_features_h5
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models.weights_clip import vision_state_dict_from_jax
from path_gene_multimodal_tpu_torch.pipeline import embed as tembed
from path_gene_multimodal_tpu_torch.pipeline import tessellate as ttess

TILE = 32
VCFG = dict(image_size=32, patch_size=16, width=64, layers=2, heads=2, out_dim=24)


@pytest.fixture(scope="module")
def slides():
    level0 = np.random.default_rng(0).integers(0, 256, (200, 260, 3), dtype=np.uint8)
    return JArraySlide(level0), ArraySlide(level0)


def _coords(n, seed=1):
    rng = np.random.default_rng(seed)
    # in bounds and past the edge (read_region pads with white)
    return np.stack([rng.integers(-8, 250, n), rng.integers(-8, 190, n)], axis=1).astype(np.int64)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("n", [0, 5, 12])
def test_iter_tile_batches_matches_jax(slides, prefetch, n):
    js, ts = slides
    coords = _coords(n)
    ref = list(jtess.iter_tile_batches(js, coords, TILE, 4, prefetch=prefetch))
    got = list(ttess.iter_tile_batches(ts, coords, TILE, 4, prefetch=prefetch))
    assert len(got) == len(ref) == -(-n // 4)
    for (gt, gv), (rt, rv) in zip(got, ref):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gv, rv)
    unpadded = list(ttess.iter_tile_batches(ts, coords, TILE, 4, pad_to_batch=False,
                                            prefetch=prefetch))
    assert sum(len(v) for _, v in unpadded) == n


@pytest.fixture(scope="module")
def weights():
    """Seeded values in the JAX tower's parameter tree (shapes from
    ``eval_shape``; LayerNorm scales around 1, other vectors around 0)."""
    import jax

    jcfg, tcfg = jclip.VisionConfig(**VCFG), tclip.VisionConfig(**VCFG)
    shapes = jax.eval_shape(jclip.VisionTower(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        if leaf.ndim == 1:
            base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
            return (base + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
        scale = int(np.prod(leaf.shape[:-1])) ** -0.5
        return rng.normal(0, scale, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return jcfg, tcfg, params, vision_state_dict_from_jax(params, tcfg)


def _configs(batch=4, model_type="CLIP"):
    jcfg = j_default_config(patch_size=TILE, model_type=model_type)
    jcfg = jcfg.replace(embedding=JEmbeddingConfig(batch_size=batch, virchow2_batch_size=2))
    tcfg = default_config(patch_size=TILE, model_type=model_type,
                          embedding=EmbeddingConfig(batch_size=batch, virchow2_batch_size=2))
    return jcfg, tcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_extract_features_matches_jax(slides, weights, tmp_path, dtype):
    js, ts = slides
    jv, tv, params, sd = weights
    jcfg, tcfg = _configs()
    coords = _coords(10, seed=2)
    ref = j_run(js, coords, jclip.ImageEncoder(jv, params=params, dtype=getattr(jnp, dtype)),
                tmp_path / "jax", "s", jcfg)
    enc = tclip.ImageEncoder(tv, state_dict=sd, dtype=getattr(torch, dtype), device="cpu")
    got = tembed.run_extract_features(ts, coords, enc, tmp_path / "port", "s", tcfg)
    assert got.dtype == np.float32 and got.shape == ref.shape == (10, 24)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    else:
        cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
        assert cos.min() >= 0.999
    # the artifacts: either package's reader reads either's H5 alike
    for h5 in (tmp_path / "jax" / "s_features.h5", tmp_path / "port" / "s_features.h5"):
        a, b = read_features_h5(h5), j_read_features_h5(h5)
        np.testing.assert_array_equal(a["features"], b["features"])
        np.testing.assert_array_equal(a["tile_index"], b["tile_index"])
        assert set(a["attrs"]) == set(b["attrs"]) == {"model_type", "dim"}
        assert a["attrs"]["model_type"] == b["attrs"]["model_type"] == "CLIP"
        assert int(a["attrs"]["dim"]) == int(b["attrs"]["dim"]) == 24
        np.testing.assert_array_equal(a["tile_index"], np.arange(10))
    port = read_features_h5(tmp_path / "port" / "s_features.h5")
    np.testing.assert_array_equal(port["features"], got)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "s_features.npy"), got)
    pt = torch.load(tmp_path / "port" / "s_features.pt", weights_only=True)
    np.testing.assert_array_equal(pt.numpy(), got)


def test_run_extract_features_empty_slide(slides, weights, tmp_path):
    js, ts = slides
    jv, tv, params, sd = weights
    jcfg, tcfg = _configs()
    empty = np.zeros((0, 2), np.int64)
    ref = j_run(js, empty, jclip.ImageEncoder(jv, params=params, dtype=jnp.float32),
                tmp_path / "jax", "e", jcfg)
    enc = tclip.ImageEncoder(tv, state_dict=sd, dtype=torch.float32, device="cpu")
    got = tembed.run_extract_features(ts, empty, enc, tmp_path / "port", "e", tcfg)
    assert got.shape == ref.shape == (0, enc.out_dim)
    h5 = read_features_h5(tmp_path / "port" / "e_features.h5")
    assert h5["features"].shape == (0, 24) and int(h5["attrs"]["dim"]) == 24


def test_virchow_model_type_clamps_batch(slides, weights, tmp_path, monkeypatch):
    """``model_type`` "Virchow2" clamps the batch to
    ``virchow2_batch_size`` and is what the artifact records."""
    _, ts = slides
    _, tv, _, sd = weights
    _, tcfg = _configs(batch=8, model_type="Virchow2")
    seen = []
    orig = tembed.iter_tile_batches

    def spy(slide, coords, tile, batch, **kw):
        seen.append(batch)
        return orig(slide, coords, tile, batch, **kw)

    monkeypatch.setattr(tembed, "iter_tile_batches", spy)
    enc = tclip.ImageEncoder(tv, state_dict=sd, dtype=torch.float32, device="cpu")
    feats = tembed.run_extract_features(ts, _coords(5), enc, tmp_path, "v", tcfg)
    assert seen == [2] and feats.shape == (5, 24)
    assert read_features_h5(tmp_path / "v_features.h5")["attrs"]["model_type"] == "Virchow2"


def test_batch_invariance(weights):
    """Identical tiles in one batch give identical rows."""
    _, tv, _, sd = weights
    enc = tclip.ImageEncoder(tv, state_dict=sd, dtype=torch.float32, device="cpu")
    tile = np.random.default_rng(0).integers(0, 256, (TILE, TILE, 3), dtype=np.uint8)
    out = enc(np.stack([tile] * 4)).numpy()
    for i in range(1, 4):
        np.testing.assert_allclose(out[0], out[i], atol=1e-5)


def test_embedding_config_matches_jax():
    j, t = JEmbeddingConfig(), EmbeddingConfig()
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__}
