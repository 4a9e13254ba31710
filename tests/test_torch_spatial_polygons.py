"""Steps 5-7 of the port against the JAX package on the CPU: the TME flags
(both corner metrics, distances that straddle the margin, more tumor boxes
than a chunk), the spatial join with its compat switches, and the polygons
(the grid, the smoothing with K5's plain version in the small-object
removal, the overlap modes, the blur) and GeoJSON, identical on the JAX
tests' inputs (``test_tme_spatial.py``, ``test_contours_polygons.py``) and
on seeded grids."""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.core.artifacts import write_tessellation_h5
from path_gene_multimodal_tpu.ops import tme as jtme
from path_gene_multimodal_tpu.pipeline import polygons as jpoly
from path_gene_multimodal_tpu.pipeline import spatial as jspatial
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.ops import morphology as tmorph
from path_gene_multimodal_tpu_torch.ops import tme as ttme
from path_gene_multimodal_tpu_torch.pipeline import polygons as tpoly
from path_gene_multimodal_tpu_torch.pipeline import spatial as tspatial

SIZE, MARGIN = 508.0, 1016.0


@pytest.fixture(autouse=True)
def _threads():
    # small torch ops on many threads crawl when six test workers share the
    # cores: cap them, as the other files that run torch on the CPU do
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("corners", ["polygon8", "euclid"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tme_distances_and_flags_match_jax(corners, seed):
    rng = np.random.default_rng(seed)
    tumors = rng.uniform(0, 4000, size=(6, 2)).astype(np.float32)
    tiles = rng.uniform(-2000, 6000, size=(250, 2)).astype(np.float32)
    want = np.asarray(jtme.min_box_distance_sq(jnp.asarray(tiles), jnp.asarray(tumors), SIZE,
                                               corners=corners))
    got = ttme.min_box_distance_sq(torch.from_numpy(tiles), torch.from_numpy(tumors), SIZE,
                                   corners=corners)
    np.testing.assert_array_equal(got.numpy(), want)
    is_tumor = rng.random(250) < 0.1
    eligible = rng.random(250) < 0.8
    np.testing.assert_array_equal(
        ttme.tme_roi_flags(tiles, is_tumor, eligible, SIZE, MARGIN, corners, device="cpu"),
        jtme.tme_roi_flags(tiles, is_tumor, eligible, SIZE, MARGIN, corners))


def test_tme_margin_band_and_chunks_match_jax():
    # grid tiles at the margin: 224-px multiples put box gaps on 1016 exactly
    xy = np.array([[x * 224, y * 224] for y in range(14) for x in range(14)], np.float32)
    tumor = np.zeros(len(xy), bool)
    tumor[[0, 50, 97]] = True
    for corners in ("polygon8", "euclid"):
        np.testing.assert_array_equal(
            ttme.tme_roi_flags(xy, tumor, np.ones(len(xy), bool), SIZE, MARGIN, corners,
                               device="cpu"),
            jtme.tme_roi_flags(xy, tumor, np.ones(len(xy), bool), SIZE, MARGIN, corners))
    ang, r = np.deg2rad(28.125), 1013.0  # inside the disc, outside shapely's 16-gon
    band = np.array([[SIZE + r * np.cos(ang), SIZE + r * np.sin(ang)]], np.float32)
    zero = torch.zeros((1, 2))
    assert float(ttme.min_box_distance_sq(torch.from_numpy(band), zero, SIZE)) > MARGIN ** 2
    assert float(ttme.min_box_distance_sq(torch.from_numpy(band), zero, SIZE,
                                          corners="euclid")) < MARGIN ** 2
    rng = np.random.default_rng(9)
    tiles = rng.uniform(0, 100000, size=(64, 2)).astype(np.float32)
    tumors = rng.uniform(0, 100000, size=(1100, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        ttme.min_box_distance_sq(torch.from_numpy(tiles), torch.from_numpy(tumors), 224.0).numpy(),
        np.asarray(jtme.min_box_distance_sq(jnp.asarray(tiles), jnp.asarray(tumors), 224.0)))
    with pytest.raises(ValueError, match="No tumor tiles"):
        ttme.tme_roi_flags(xy[:3], np.zeros(3, bool), np.ones(3, bool), SIZE, MARGIN,
                           device="cpu")
    with pytest.raises(ValueError, match="No TME tiles"):
        ttme.tme_roi_flags(xy[:3], np.ones(3, bool), np.zeros(3, bool), SIZE, MARGIN,
                           device="cpu")


@pytest.fixture
def spatial_setup(tmp_path):
    classes = list(default_config().classes)
    coords = np.array([[x * 224, y * 224] for y in range(10) for x in range(10)], np.int64)
    rng = np.random.default_rng(4)
    scores = rng.random((len(coords), 5)).astype(np.float32)
    scores[:, 2] += 1.0  # mostly TILs; one tumor seed, a necrosis patch
    scores[[0, 1], 0] += 2.0
    scores[[77, 78, 87], 4] += 2.0
    write_tessellation_h5(tmp_path / "s.h5", coords, tile_size=224)
    df = pd.DataFrame(scores, columns=classes)
    df.insert(0, "tile_index", np.arange(len(coords)))
    df.to_csv(tmp_path / "s_annotations.csv", index=False)
    (tmp_path / "patches").mkdir()
    return tmp_path, classes


@pytest.mark.parametrize("compat", [{}, {"tme_classes_default_all": False},
                                    {"legacy_png_names": True},
                                    {"polygonal_buffer_corners": False}])
def test_spatial_join_matches_jax(spatial_setup, compat):
    tmp_path, classes = spatial_setup
    jcfg, tcfg = j_default_config(), default_config()
    jcfg = jcfg.replace(compat=dataclasses.replace(jcfg.compat, **compat))
    tcfg = tcfg.replace(compat=dataclasses.replace(tcfg.compat, **compat))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for d in ("j", "t"):
        for f in ("s.h5", "s_annotations.csv"):
            (tmp_path / d / f).write_bytes((tmp_path / f).read_bytes())
        (tmp_path / d / "patches").mkdir()
    want = jspatial.run_spatial_join(tmp_path / "j", "s", jcfg)
    got = tspatial.run_spatial_join(tmp_path / "t", "s", tcfg, device="cpu")
    assert list(got.columns) == list(want.columns)
    a = pd.read_csv(tmp_path / "t" / "s_annotations_with_coords.csv")
    b = pd.read_csv(tmp_path / "j" / "s_annotations_with_coords.csv")
    a["png_path"] = a["png_path"].str.replace(str(tmp_path / "t"), "")
    b["png_path"] = b["png_path"].str.replace(str(tmp_path / "j"), "")
    pd.testing.assert_frame_equal(a, b)
    assert a["in_tme_roi"].any() and not a["in_tme_roi"].all()


def _tile_df():
    """The JAX test's 12 x 12 grid: a 4x4 tumor block, a 3x3 TILs block, one
    isolated necrosis tile, the rest stroma."""
    classes = list(default_config().classes)
    rows = []
    for gy in range(12):
        for gx in range(12):
            if 2 <= gx < 6 and 2 <= gy < 6:
                c = classes[0]
            elif 8 <= gx < 11 and 7 <= gy < 10:
                c = classes[2]
            elif gx == 0 and gy == 11:
                c = classes[4]
            else:
                c = classes[1]
            scores = {cls: (0.9 if cls == c else 0.02) for cls in classes}
            rows.append({"tile_index": gy * 12 + gx, "x": gx * 224, "y": gy * 224,
                         "predicted_class": c, **scores})
    return pd.DataFrame(rows), classes


def _seeded_df(seed):
    """A seeded 20 x 16 grid of blobby classes with gaps (rank compression
    collapses them), and random score columns."""
    classes = list(default_config().classes)
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 5, (5, 4)).repeat(4, 0).repeat(4, 1)
    lab = np.where(rng.random(lab.shape) < 0.15, rng.integers(0, 5, lab.shape), lab)
    keep = rng.random(lab.shape) > 0.05
    keep[:, 7] = False  # a column gap
    gy, gx = np.nonzero(keep)
    scores = rng.random((len(gy), 5)).astype(np.float32)
    scores[np.arange(len(gy)), lab[gy, gx]] += 1.0
    df = pd.DataFrame(scores, columns=classes)
    df.insert(0, "tile_index", np.arange(len(gy)))
    df["x"], df["y"] = gx * 224, gy * 224
    df["predicted_class"] = [classes[i] for i in scores.argmax(1)]
    return df, classes


PARAMS = [
    dict(),
    dict(smooth_radius_tiles=0.0, area_min_tiles=1),
    dict(smooth_radius_tiles=2.0, area_min_tiles=3),
    dict(blur_sigma=1.0, area_min_tiles=2),
    dict(overlap_mode="priority", area_min_tiles=3),
    dict(min_polygon_area_px=0, simplify_frac=0.5, area_min_tiles=1),
]


def _cfgs(params, rank=True):
    jcfg, tcfg = j_default_config(), default_config()
    jcfg = jcfg.replace(polygon=dataclasses.replace(jcfg.polygon, **params),
                        compat=dataclasses.replace(jcfg.compat, rank_compressed_grid=rank))
    tcfg = tcfg.replace(polygon=dataclasses.replace(tcfg.polygon, **params),
                        compat=dataclasses.replace(tcfg.compat, rank_compressed_grid=rank))
    return jcfg, tcfg


@pytest.mark.parametrize("which,rank", [("tile_df", True), ("seed0", True), ("seed0", False),
                                        ("seed1", True)])
@pytest.mark.parametrize("p", range(len(PARAMS)))
def test_polygons_match_jax(tmp_path, which, rank, p):
    df, classes = _tile_df() if which == "tile_df" else _seeded_df(int(which[-1]))
    jcfg, tcfg = _cfgs(PARAMS[p], rank)
    jgrid = jpoly.tiles_to_grid(df, classes, rank_compressed=rank)
    tgrid = tpoly.tiles_to_grid(df, classes, rank_compressed=rank)
    for k in ("label_grid", "prob_grids", "x_coords", "y_coords"):
        np.testing.assert_array_equal(tgrid[k], jgrid[k])
    pp = jcfg.polygon
    kw = dict(smooth_radius_tiles=pp.smooth_radius_tiles, blur_sigma=pp.blur_sigma,
              area_min_tiles=pp.area_min_tiles, overlap_mode=pp.overlap_mode)
    np.testing.assert_array_equal(tpoly.smooth_and_resolve(tgrid, 5, device="cpu", **kw),
                                  jpoly.smooth_and_resolve(jgrid, 5, **kw))
    want = jpoly.build_polygons_for_all_classes(df, classes, jcfg)
    got = tpoly.build_polygons_for_all_classes(df, classes, tcfg, device="cpu")
    assert [f["class_name"] for f in got] == [f["class_name"] for f in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["exterior"], w["exterior"])
        assert (g["area_px2"], g["perimeter_px"]) == (w["area_px2"], w["perimeter_px"])
    a = tpoly.export_geojson(got, tmp_path / "t", "s")
    b = jpoly.export_geojson(want, tmp_path / "j", "s")
    assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_polygons_find_something():
    df, classes = _tile_df()
    _, tcfg = _cfgs({})
    feats = tpoly.build_polygons_for_all_classes(df, classes, tcfg, device="cpu")
    assert {f["class_name"] for f in feats} >= {classes[0], classes[1]}


def test_gaussian_blur_matches_jax():
    from path_gene_multimodal_tpu.ops import morphology as jmorph

    m = np.random.default_rng(2).random((3, 17, 23)) < 0.5
    for sigma in (0.6, 1.0, 2.5):
        want = np.asarray(jmorph.gaussian_blur(jnp.asarray(m, jnp.float32), sigma))
        got = tmorph.gaussian_blur(torch.from_numpy(m), sigma).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_array_equal(got > 0.5, want > 0.5)
