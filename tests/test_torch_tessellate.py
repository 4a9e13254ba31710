"""Step 1 of the port against the JAX package on the CPU: the masking ops
(Otsu's threshold over a seeded sweep that includes sums past 2^24, the
3×3 median, ``tissue_mask`` with and without ``valid_hw``), the grid ops,
and ``run_tessellation``: coords, the H5 (read by both packages) and the
PNGs' pixels (the JAX package writes them with cv2, the port with its own
zlib writer) equal; the per-tile PNGs and a grid wider than the
thumbnail."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.core.artifacts import read_tessellation_h5 as j_read_h5
from path_gene_multimodal_tpu.io.slide import synthetic_wsi
from path_gene_multimodal_tpu.ops import gridops as jgrid
from path_gene_multimodal_tpu.ops import masking as jmask
from path_gene_multimodal_tpu.pipeline.tessellate import run_tessellation as j_run
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.core.artifacts import read_tessellation_h5
from path_gene_multimodal_tpu_torch.io.png import write_png
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide
from path_gene_multimodal_tpu_torch.ops import gridops, masking
from path_gene_multimodal_tpu_torch.pipeline.tessellate import run_tessellation


@pytest.fixture(autouse=True)
def _threads():
    # small torch ops on many threads crawl when six test workers share the
    # cores: cap them, as the other files that run torch on the CPU do
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _image(seed: int, shape) -> np.ndarray:
    """Seeded uint8 images of several kinds: uniform, two modes, skewed."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == 1:
        lo = rng.normal(rng.uniform(10, 90), rng.uniform(2, 20), shape)
        hi = rng.normal(rng.uniform(120, 240), rng.uniform(2, 30), shape)
        return np.where(rng.random(shape) < rng.uniform(0.1, 0.9), lo, hi).clip(0, 255).astype(
            np.uint8)
    return (rng.gamma(rng.uniform(0.5, 3), rng.uniform(5, 40), shape)).clip(0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("seed", range(16))
def test_otsu_sweep_matches_jax(seed):
    # up to 1024^2 pixels: sum(hist * bins) passes 2^24, where f32 sums round
    side = (64, 200, 512, 1024)[seed % 4]
    img = _image(seed, (side, side))
    weights = (np.random.default_rng(seed).random(img.shape) < 0.9) if seed % 5 == 0 else None
    want = int(jmask.otsu_threshold(jnp.asarray(img), None if weights is None
                                    else jnp.asarray(weights)))
    got = masking.otsu_threshold(torch.from_numpy(img),
                                 None if weights is None else torch.from_numpy(weights))
    assert got.dtype == torch.uint8 and int(got) == want


def test_median_and_histogram_match_jax():
    img = _image(1, (37, 53))
    np.testing.assert_array_equal(masking.median_blur_3x3(torch.from_numpy(img)).numpy(),
                                  np.asarray(jmask.median_blur_3x3(jnp.asarray(img))))
    np.testing.assert_array_equal(masking.histogram_256(torch.from_numpy(img)).numpy(),
                                  np.asarray(jmask.histogram_256(jnp.asarray(img))))


@pytest.mark.parametrize("seed", [7, 11, 13])
@pytest.mark.parametrize("use_otsu", [True, False])
def test_tissue_mask_matches_jax(seed, use_otsu):
    slide = synthetic_wsi(2048, 1536, seed=seed, n_blobs=3, nuclei_per_blob=20)
    thumb = slide.get_thumbnail((512, 512))
    want = np.asarray(jmask.tissue_mask(jnp.asarray(thumb), use_otsu=use_otsu))
    got = masking.tissue_mask(torch.from_numpy(thumb), use_otsu=use_otsu).numpy()
    np.testing.assert_array_equal(got, want)
    th, tw = thumb.shape[:2]
    pad = np.zeros((520, 520, 3), np.uint8)
    pad[:th, :tw] = thumb
    jp = np.asarray(jmask.tissue_mask(jnp.asarray(pad), use_otsu=use_otsu,
                                      valid_hw=jnp.asarray([th, tw], jnp.int32)))
    tp = masking.tissue_mask(torch.from_numpy(pad), use_otsu=use_otsu, valid_hw=(th, tw)).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tp[:th, :tw], got)


@pytest.mark.parametrize("scale", [2.0, 7.3, 20.96])
def test_tile_fractions_match_jax(scale):
    rng = np.random.default_rng(int(scale * 10))
    mask = rng.random((97, 131)) < 0.4
    edges = gridops.tile_edges_for_scale(97, 131, 224, scale)
    want_edges = jgrid.tile_edges_for_scale(97, 131, 224, scale)
    for a, b in zip(edges, want_edges):
        np.testing.assert_array_equal(a, b)
    y0, y1, x0, x1 = edges[:4]
    want = np.asarray(jgrid.tile_foreground_fraction_edges(
        jnp.asarray(mask), *(jnp.asarray(e) for e in (y0, y1, x0, x1))))
    got = gridops.tile_foreground_fraction_edges(torch.from_numpy(mask), y0, y1, x0, x1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_grid_helpers_match_jax():
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(gridops.full_tile_grid(1000, 700, 224),
                                  jgrid.full_tile_grid(1000, 700, 224))
    coords = np.array([[0, 0], [224, 0], [448, 224], [224, 448], [672, 448]], np.int64)
    assert gridops.infer_tile_size(coords) == jgrid.infer_tile_size(coords) == 224
    assert gridops.infer_tile_size(np.array([[5, 5]])) == 224
    shape = gridops.tiles_to_grid_shape(coords, 224)
    assert shape == jgrid.tiles_to_grid_shape(coords, 224)
    vals = rng.normal(size=(5, 3)).astype(np.float32)
    padded = np.concatenate([coords, [[-1, -1]]])
    pvals = np.concatenate([vals, np.full((1, 3), 99, np.float32)])
    want = np.asarray(jgrid.rasterize_tiles(jnp.asarray(padded), jnp.asarray(pvals), *shape, 224))
    got = gridops.rasterize_tiles(torch.from_numpy(padded), torch.from_numpy(pvals), *shape, 224)
    np.testing.assert_array_equal(got.numpy(), want)
    back = gridops.grid_lookup(torch.from_numpy(coords), got, *shape, 224)
    np.testing.assert_array_equal(back.numpy(), vals)


def _pixels(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def slides():
    js = synthetic_wsi(2048, 1536, seed=7, n_blobs=3, nuclei_per_blob=60)
    return js, ArraySlide(js._levels[0], mpp=js.mpp)


@pytest.mark.parametrize("patch_pngs", [False, True])
def test_run_tessellation_matches_jax(tmp_path, slides, patch_pngs):
    js, ts = slides
    jcfg, tcfg = j_default_config(), default_config()
    if patch_pngs:
        jcfg = jcfg.replace(tessellation=dataclasses.replace(jcfg.tessellation,
                                                             write_patch_pngs=True))
        tcfg = tcfg.replace(tessellation=dataclasses.replace(tcfg.tessellation,
                                                             write_patch_pngs=True))
    want = j_run(js, tmp_path / "j", jcfg, stem="s")
    got = run_tessellation(ts, tmp_path / "t", tcfg, stem="s", device="cpu")
    assert got.num_tiles > 0
    np.testing.assert_array_equal(got.coords, want.coords)
    assert got.coords.dtype == np.int64
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.mask_scale == want.mask_scale and got.slide_dims == want.slide_dims
    for reader in (read_tessellation_h5, j_read_h5):
        a, b = reader(tmp_path / "t" / "s.h5"), reader(tmp_path / "j" / "s.h5")
        np.testing.assert_array_equal(a["coords"], b["coords"])
        assert set(a["attrs"]) == set(b["attrs"])
        for k in a["attrs"]:
            np.testing.assert_array_equal(a["attrs"][k], b["attrs"][k])
    for name in ("thumbnail.png", "mask.png", "grid_mask.png"):
        np.testing.assert_array_equal(_pixels(tmp_path / "t" / name),
                                      _pixels(tmp_path / "j" / name))
    if patch_pngs:
        names = sorted(p.name for p in (tmp_path / "j" / "patches").glob("*.png"))
        assert names == sorted(p.name for p in (tmp_path / "t" / "patches").glob("*.png"))
        for n in names[:: max(1, len(names) // 4)]:
            np.testing.assert_array_equal(_pixels(tmp_path / "t" / "patches" / n),
                                          _pixels(tmp_path / "j" / "patches" / n))


def test_grid_wider_than_thumbnail_matches_jax(tmp_path):
    js = synthetic_wsi(16384, 512, seed=7, n_blobs=6, nuclei_per_blob=20)
    ts = ArraySlide(js._levels[0], mpp=js.mpp)
    jcfg, tcfg = j_default_config(), default_config()
    jcfg = jcfg.replace(tessellation=dataclasses.replace(jcfg.tessellation, thumbnail_size=64))
    tcfg = tcfg.replace(tessellation=dataclasses.replace(tcfg.tessellation, thumbnail_size=64))
    want = j_run(js, tmp_path, jcfg, stem="huge", write_artifacts=False)
    got = run_tessellation(ts, tmp_path, tcfg, stem="huge", write_artifacts=False, device="cpu")
    assert got.num_tiles > 0
    np.testing.assert_array_equal(got.coords, want.coords)


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3), (1, 1)])
def test_png_writer_pixels(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(_pixels(write_png(tmp_path / "x.png", img)), img)
