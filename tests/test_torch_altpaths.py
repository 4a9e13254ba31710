"""The port's alternative polygon paths and legacy summaries against the
JAX package on the CPU: ``legacy.summarize_tumor_area`` and
``tumor_bounding_boxes`` (frames equal), ``altpaths.tumor_polygon_from_patches``
(rings equal), ``tumor_geojson_for_slides`` (GeoJSON bytes equal),
``mask_contour_from_tiles`` (rings equal) and
``composite_polygons_on_thumbnail`` (pixels equal), on tumour blobs drawn
from numpy seeds, with the empty and all-removed cases; and the CC caps of
the raster path: on a staircase deeper than the XLA labeller's 257
relaxations the JAX removal (``use_pallas=False``) cuts the component
short, where the port's (K5's plain version) equals scipy's labels."""

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops import components as jcc
from path_gene_multimodal_tpu.pipeline import altpaths as jalt
from path_gene_multimodal_tpu.pipeline import legacy as jleg
from path_gene_multimodal_tpu_torch.ops import components as tcc
from path_gene_multimodal_tpu_torch.pipeline import altpaths as talt
from path_gene_multimodal_tpu_torch.pipeline import legacy as tleg

PATCH = 224
CLASSES = ["Tumor", "Stroma", "TILs", "Necrosis", "Normal"]
TUMOR = ["Tumor", "Necrosis"]


@pytest.fixture(autouse=True)
def _threads():
    # small torch ops on many threads crawl when six test workers share the
    # cores: cap them, as the other files that run torch on the CPU do
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blob_coords(seed: int, gw: int = 30, gh: int = 24, blobs: int = 4) -> np.ndarray:
    """Top-left level-0 coords of the tiles inside ``blobs`` random discs
    (radius 1.5-5 tiles) on a gw x gh tile grid, plus a few strays."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:gh, 0:gw]
    keep = rng.random((gh, gw)) < 0.02
    for _ in range(blobs):
        cx, cy, r = rng.uniform(0, gw), rng.uniform(0, gh), rng.uniform(1.5, 5)
        keep |= (gx - cx) ** 2 + (gy - cy) ** 2 <= r * r
    return np.stack([gx[keep], gy[keep]], 1).astype(np.int64) * PATCH + 448


def _frame(seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    gh, gw = 20, 26
    gy, gx = np.mgrid[0:gh, 0:gw]
    tissue = rng.random((gh, gw)) < 0.7
    cls = rng.choice(CLASSES, size=int(tissue.sum()), p=[0.1, 0.4, 0.2, 0.1, 0.2])
    tumor_blob = set(map(tuple, _blob_coords(seed + 50, gw, gh, 3) // PATCH - 2))
    xs, ys = gx[tissue], gy[tissue]
    cls = [("Tumor" if (x, y) in tumor_blob else c) for x, y, c in zip(xs, ys, cls)]
    return pd.DataFrame({"x": xs * PATCH + 1000, "y": ys * PATCH + 600, "predicted_class": cls})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_legacy_summaries_equal_jax(seed):
    df = _frame(seed)
    pd.testing.assert_frame_equal(tleg.summarize_tumor_area(df, CLASSES, TUMOR, PATCH),
                                  jleg.summarize_tumor_area(df, CLASSES, TUMOR, PATCH),
                                  check_exact=True)
    got = tleg.tumor_bounding_boxes(df, TUMOR, PATCH, device="cpu")
    want = jleg.tumor_bounding_boxes(df, TUMOR, PATCH)
    assert len(want) > 1
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_legacy_empty_cases_equal_jax():
    df = _frame(0)
    none = df[~df["predicted_class"].isin(TUMOR)]
    pd.testing.assert_frame_equal(tleg.tumor_bounding_boxes(none, TUMOR, PATCH, device="cpu"),
                                  jleg.tumor_bounding_boxes(none, TUMOR, PATCH))
    empty = df.iloc[:0]
    pd.testing.assert_frame_equal(tleg.summarize_tumor_area(empty, CLASSES, TUMOR, PATCH),
                                  jleg.summarize_tumor_area(empty, CLASSES, TUMOR, PATCH),
                                  check_exact=True)


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {}), (2, {"raster_scale": 2}),
                                     (3, {"smooth_radius_px": 300.0, "simplify_px": 10.0})])
def test_tumor_polygon_from_patches_equal_jax(seed, kw):
    coords = _blob_coords(seed)
    want = jalt.tumor_polygon_from_patches(coords, PATCH, **kw)
    got = talt.tumor_polygon_from_patches(coords, PATCH, device="cpu", **kw)
    assert want is not None and len(want) >= 3
    np.testing.assert_array_equal(got, want)


def test_tumor_polygon_none_cases_equal_jax():
    empty = np.zeros((0, 2), np.int64)
    assert talt.tumor_polygon_from_patches(empty, PATCH, device="cpu") is None
    assert jalt.tumor_polygon_from_patches(empty, PATCH) is None
    # every polygon under the area floor: removed in both
    coords = _blob_coords(4)
    assert jalt.tumor_polygon_from_patches(coords, PATCH, min_area_px2=1e12) is None
    assert talt.tumor_polygon_from_patches(coords, PATCH, min_area_px2=1e12, device="cpu") is None


def test_tumor_geojson_bytes_equal_jax(tmp_path):
    per_slide = {"slide.a": _blob_coords(5), "slide-b": _blob_coords(6, blobs=2),
                 "empty": np.zeros((0, 2), np.int64)}
    want = jalt.tumor_geojson_for_slides(per_slide, PATCH, tmp_path / "jax")
    got = talt.tumor_geojson_for_slides(per_slide, PATCH, tmp_path / "port", device="cpu")
    assert sorted(got) == sorted(want) == ["slide-b", "slide.a"]
    for stem in want:
        assert got[stem].name == want[stem].name
        assert got[stem].read_bytes() == want[stem].read_bytes()


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {}), (2, {"close_frac": 0.5, "open_frac": 1.5})])
def test_mask_contour_from_tiles_equal_jax(seed, kw):
    coords, dims = _blob_coords(seed), (8000, 6200)
    want = jalt.mask_contour_from_tiles(coords, PATCH, dims, **kw)
    got = talt.mask_contour_from_tiles(coords, PATCH, dims, device="cpu", **kw)
    assert len(want) >= 2
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mask_contour_empty_and_all_removed_equal_jax():
    assert talt.mask_contour_from_tiles(np.zeros((0, 2)), PATCH, (8000, 6200), device="cpu") == []
    coords = _blob_coords(7)
    assert jalt.mask_contour_from_tiles(coords, PATCH, (8000, 6200), min_area_frac=1e4) == []
    assert talt.mask_contour_from_tiles(coords, PATCH, (8000, 6200), min_area_frac=1e4,
                                        device="cpu") == []


def test_raster_geometry_is_jax_raster():
    g = talt.raster_geometry((100_000, 80_000), PATCH)
    assert (g["pw"], g["ph"], g["patch_r"]) == (6144, 4864, 13)
    assert talt.raster_geometry((8000, 6200), PATCH)["scale"] == PATCH / 16.0


def test_composite_equal_jax():
    rng = np.random.default_rng(8)
    thumb = rng.integers(0, 256, (180, 240, 3), dtype=np.uint8)
    rings = jalt.mask_contour_from_tiles(_blob_coords(8), PATCH, (8000, 6200))
    rings.append(np.array([[10.0, 10.0], [500.0, 40.0]]))  # < 3 points: skipped
    np.testing.assert_array_equal(talt.composite_polygons_on_thumbnail(thumb, rings, 8000 / 240),
                                  jalt.composite_polygons_on_thumbnail(thumb, rings, 8000 / 240))


def _staircase(steps: int) -> np.ndarray:
    """A 4-connected staircase down and right from (0, 0): one component
    whose labels (the minimum at its top-left end) move one step per
    relaxation of a row pass and a column pass."""
    m = np.zeros((steps + 1, steps + 2), bool)
    for i in range(steps + 1):
        m[i, i : i + 2] = True
    return m


def test_raster_removal_caps_k5_converges_where_xla_stops():
    """The raster path's removal in JAX labels with the XLA fixpoint (at
    most 1 + 256 relaxations); the port's labels with K5 (128 a tile and
    round, 64 rounds; here its plain version). On a 300-step staircase the
    XLA labels stop short and split the one component, so JAX removes it at
    a min_size of its whole area; K5 converges, and the port's removal
    keeps it, as scipy's labels say it is one component. Where both
    converge (100 steps) they agree."""
    m = _staircase(300)
    area = int(m.sum())
    assert ndimage.label(m)[1] == 1
    xla = np.asarray(jcc.label_components(jnp.asarray(m), 1))
    assert len(np.unique(xla[m])) > 1  # the cap binds in JAX
    # the port's plain XLA labeller keeps JAX's cap, split for split
    np.testing.assert_array_equal(
        tcc.label_components(torch.from_numpy(m)[None])[0].numpy(), xla)
    want = np.asarray(jcc.remove_small_objects(jnp.asarray(m), area))
    got = tcc.remove_small_objects(torch.from_numpy(m), area).numpy()
    assert want.sum() < area
    np.testing.assert_array_equal(got, m)
    m2 = np.zeros_like(m)  # the same shape: JAX's compiled removal is reused
    m2[:101, :102] = _staircase(100)
    np.testing.assert_array_equal(
        tcc.remove_small_objects(torch.from_numpy(m2), int(m2.sum())).numpy(),
        np.asarray(jcc.remove_small_objects(jnp.asarray(m2), int(m2.sum()))))
