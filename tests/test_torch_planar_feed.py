"""The planar 4:2:0 feed of the port against the JAX package's, on the CPU:
``ycbcr420_to_rgb`` bit for bit (and equal to the nearest RGB decode),
planar ``iter_tile_batches`` payloads from a JPEG TIFF (with a chunk that
falls back to RGB), planar ``run_extract_features`` at the embed stage's
tolerance, the nuclei stage's ``_planar_seg_prep`` against the host pad,
``NucleiConfig``'s defaults, and the measured gap between fancy and nearest
chroma that replaces the JAX docstring's "at most +-1 level"."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.config import EmbeddingConfig as JEmbeddingConfig
from path_gene_multimodal_tpu.config import HoverNeXtConfig as JNucleiConfig
from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.io.tiff import TiffTileSlide as JSlide
from path_gene_multimodal_tpu.io.tiff_write import write_tiled_tiff as j_write_tiled
from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.ops.jpegcolor import ycbcr420_to_rgb as j_ycbcr420_to_rgb
from path_gene_multimodal_tpu.pipeline import tessellate as jtess
from path_gene_multimodal_tpu.pipeline.embed import run_extract_features as j_run
from path_gene_multimodal_tpu_torch.config import EmbeddingConfig, NucleiConfig, default_config
from path_gene_multimodal_tpu_torch.io.native import NativeTileDecoder
from path_gene_multimodal_tpu_torch.io.slide import synthetic_wsi
from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide
from path_gene_multimodal_tpu_torch.io.tiff_write import encode_jpeg
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models.weights_clip import vision_state_dict_from_jax
from path_gene_multimodal_tpu_torch.ops.jpegcolor import ycbcr420_to_rgb
from path_gene_multimodal_tpu_torch.pipeline import embed as tembed
from path_gene_multimodal_tpu_torch.pipeline import tessellate as ttess
from path_gene_multimodal_tpu_torch.pipeline.nuclei import _pad_tile_to_input, _planar_seg_prep


@pytest.mark.parametrize("shape", [(2, 256, 256), (1, 37, 51)])
def test_ycbcr420_to_rgb_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    y = rng.integers(0, 256, shape, dtype=np.uint8)
    c = rng.integers(0, 256, shape[:-2] + ((shape[-2] + 1) // 2, (shape[-1] + 1) // 2, 2),
                     dtype=np.uint8)
    c[..., :3, :3, :] = [[0, 255]]  # the extremes of both chroma tables
    got = ycbcr420_to_rgb(torch.from_numpy(y), torch.from_numpy(c))
    assert got.dtype == torch.uint8 and got.shape == shape + (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_ycbcr420_to_rgb(y, c)))


@pytest.fixture(scope="module")
def jpeg_slide(tmp_path_factory):
    """A 1024 x 768 synthetic H&E slide as a JPEG TIFF (256-px tiles, q90)."""
    lv = synthetic_wsi(1024, 768, seed=5, n_blobs=3, nuclei_per_blob=150)._levels[0]
    p = j_write_tiled(tmp_path_factory.mktemp("planar") / "s.svs", [lv], tile_size=256,
                      compression=7, description="Aperio |MPP = 0.25|")
    return p


def test_planar_equals_nearest_decode(jpeg_slide):
    """Planes through ``ycbcr420_to_rgb`` = the nearest RGB decode."""
    t = TiffTileSlide(jpeg_slide)
    page = t._pages[0]
    blobs = [t._tile_bytes(page, i) for i in range(len(page.offsets))]
    dec = NativeTileDecoder()
    y, c = dec.decode_jpeg_batch_planar(blobs, 256, 256)
    np.testing.assert_array_equal(ycbcr420_to_rgb(torch.from_numpy(y), torch.from_numpy(c)).numpy(),
                                  dec.decode_jpeg_batch_nearest(blobs, 256, 256))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_iter_tile_batches_planar_matches_jax(jpeg_slide, prefetch):
    j, t = JSlide(jpeg_slide), TiffTileSlide(jpeg_slide)
    side = np.arange(0, 768 - 224, 224)
    grid = np.stack(np.meshgrid(np.arange(0, 1024 - 224, 224), side), -1).reshape(-1, 2)
    # chunks of 4: two planar, one with an odd origin (falls back to RGB),
    # one planar chunk of 1 padded to the batch
    coords = np.concatenate([grid[:8], [[101, 100]], grid[8:]]).astype(np.int64)
    ref = list(jtess.iter_tile_batches(j, coords, 224, 4, planar=True, prefetch=prefetch))
    got = list(ttess.iter_tile_batches(t, coords, 224, 4, planar=True, prefetch=prefetch))
    kinds = [isinstance(p, tuple) for p, _ in got]
    assert kinds == [isinstance(p, tuple) for p, _ in ref] == [True, True, False, True]
    for (gp, gv), (rp, rv) in zip(got, ref):
        np.testing.assert_array_equal(gv, rv)
        for a, b in zip(gp if isinstance(gp, tuple) else (gp,), rp if isinstance(rp, tuple) else (rp,)):
            np.testing.assert_array_equal(a, b)
    (y, c), valid = got[3]
    assert valid.tolist() == [True, False, False, False]  # padded black
    assert (y[1:] == 0).all() and (c[1:] == 128).all()
    last, _ = got[2]
    np.testing.assert_array_equal(last[0], t.read_region((101, 100), 0, (224, 224)))


TILE = 32
VCFG = dict(image_size=32, patch_size=16, width=64, layers=2, heads=2, out_dim=24)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jclip.VisionConfig(**VCFG), tclip.VisionConfig(**VCFG)
    shapes = jax.eval_shape(jclip.VisionTower(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        if leaf.ndim == 1:
            base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
            return (base + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
        return rng.normal(0, int(np.prod(leaf.shape[:-1])) ** -0.5, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return jcfg, tcfg, params, vision_state_dict_from_jax(params, tcfg)


def test_run_extract_features_planar_matches_jax(jpeg_slide, weights, tmp_path, monkeypatch):
    jv, tv, params, sd = weights
    rng = np.random.default_rng(2)
    coords = np.stack([rng.integers(0, 490, 10) * 2, rng.integers(0, 360, 10) * 2], 1)
    jcfg = j_default_config(patch_size=TILE).replace(embedding=JEmbeddingConfig(batch_size=4))
    tcfg = default_config(patch_size=TILE, embedding=EmbeddingConfig(batch_size=4))
    ref = j_run(JSlide(jpeg_slide), coords, jclip.ImageEncoder(jv, params=params,
                                                                dtype=jnp.float32),
                tmp_path / "jax", "s", jcfg, write_artifacts=False)
    seen = []
    real = tembed.ycbcr420_to_rgb
    monkeypatch.setattr(tembed, "ycbcr420_to_rgb", lambda *a: seen.append(1) or real(*a))
    enc = tclip.ImageEncoder(tv, state_dict=sd, dtype=torch.float32, device="cpu")
    slide = TiffTileSlide(jpeg_slide)
    got = tembed.run_extract_features(slide, coords, enc, tmp_path / "port", "s", tcfg,
                                      write_artifacts=False)
    assert len(seen) == 3  # every batch came planar
    assert got.shape == ref.shape == (10, 24)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    # the planar run is the RGB run on the nearest decode of the same tiles
    page = slide._pages[0]
    near = NativeTileDecoder().decode_jpeg_batch_nearest(
        [slide._tile_bytes(page, i) for i in range(len(page.offsets))], 256, 256)
    canvas = near.reshape(3, 4, 256, 256, 3).transpose(0, 2, 1, 3, 4).reshape(768, 1024, 3)
    tiles = np.zeros((12, TILE, TILE, 3), np.uint8)  # the run's batches, padded black
    tiles[:10] = [canvas[y: y + TILE, x: x + TILE] for x, y in coords]
    rgb_run = np.concatenate([enc(tiles[i: i + 4]).numpy() for i in range(0, 12, 4)])
    np.testing.assert_array_equal(rgb_run[:10], got)


def test_planar_seg_prep_equals_host_pad():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (3, 224, 224), dtype=np.uint8)
    c = rng.integers(0, 256, (3, 112, 112, 2), dtype=np.uint8)
    rgb = ycbcr420_to_rgb(torch.from_numpy(y), torch.from_numpy(c)).numpy()
    got = _planar_seg_prep(torch.from_numpy(y), torch.from_numpy(c), 16, 16).numpy()
    assert got.shape == (3, 256, 256, 3)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _pad_tile_to_input(rgb[i], 256)[0])
    np.testing.assert_array_equal(
        _planar_seg_prep(torch.from_numpy(y), torch.from_numpy(c), 0, 0).numpy(), rgb)


def test_nuclei_config_matches_jax():
    t, j = NucleiConfig(), JNucleiConfig()
    assert t.planar_feed is True
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__}


def test_fancy_and_nearest_chroma_differ_by_far_more_than_one_level():
    """64 tiles of synthetic_wsi(2048, 2048, seed=11) at quality 90: the
    fancy and nearest RGB decodes differ by up to 35 levels (mean 0.356,
    99.9th percentile 13), in both packages' decoders."""
    lv = synthetic_wsi(2048, 2048, seed=11)._levels[0]
    blobs = [encode_jpeg(lv[y: y + 256, x: x + 256], 90)
             for y in range(0, 2048, 256) for x in range(0, 2048, 256)]
    dec = NativeTileDecoder()
    diff = np.abs(dec.decode_jpeg_batch(blobs, 256, 256).astype(np.int16)
                  - dec.decode_jpeg_batch_nearest(blobs, 256, 256))
    assert int(diff.max()) == 35 and float(np.percentile(diff, 99.9)) == 13.0
    assert abs(float(diff.mean()) - 0.356) < 1e-3
