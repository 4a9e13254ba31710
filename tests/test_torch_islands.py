"""The port's tissue-boundary / islands path (``pipeline/morphology.py``
and what it runs: HSV mask, binary morphology, cv2-free resizes,
thumbnails, GeoJSON, K5) against the JAX package and cv2, on the CPU.

Masks, rings, the islands CSV and the burden TXT (less its timestamp) must
equal the JAX package's; the resizes must equal ``cv2.resize``. cv2 and
matplotlib serve here only as oracles (the JAX package draws its PNG with
matplotlib; the port writes its own)."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.core import artifacts as jart
from path_gene_multimodal_tpu.ops import masking as jmask
from path_gene_multimodal_tpu.ops import morphology as jmorph
from path_gene_multimodal_tpu.pipeline import morphology as jpipe
from path_gene_multimodal_tpu_torch.core import artifacts as tart
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide, resize_area, resize_nearest
from path_gene_multimodal_tpu_torch.ops import masking as tmask
from path_gene_multimodal_tpu_torch.ops import morphology as tmorph
from path_gene_multimodal_tpu_torch.pipeline import morphology as tpipe

T = torch.from_numpy
CLASSES = ("Tumor", "Stroma", "TILs", "TLS")


@pytest.fixture(scope="module")
def slides(small_slide):
    """The JAX fixture slide and the port's ArraySlide over its level 0."""
    return small_slide, ArraySlide(small_slide._levels[0], mpp=small_slide.mpp)


@pytest.fixture(scope="module")
def geojson_file(tmp_path_factory):
    """Islands in level-0 px: two tumor squares, a TIL square, a TLS
    triangle, and a stroma square that no group takes."""
    sq = lambda x0, y0, s: np.array(  # noqa: E731
        [[x0, y0], [x0 + s, y0], [x0 + s, y0 + s], [x0, y0 + s]], float)
    feats = [
        {"class_name": CLASSES[0], "exterior": sq(100, 100, 600)},
        {"class_name": CLASSES[0], "exterior": sq(1200, 300, 250.5)},
        {"class_name": CLASSES[2], "exterior": sq(300, 900, 400)},
        {"class_name": CLASSES[3], "exterior": np.array([[1500, 1000], [1900, 1000], [1700, 1400]])},
        {"class_name": CLASSES[1], "exterior": sq(10, 10, 50)},
    ]
    path = tmp_path_factory.mktemp("gj") / "s.geojson"
    jart.export_geojson(path, feats)
    return path, feats


# ------------------------------------------------------------ HSV, morphology


def test_rgb_to_hsv_and_tissue_mask_bit_equal():
    """Against the JAX function as the pipeline runs it, under ``jit``
    (``tissue_mask_hsv`` is jitted): XLA turns the divisions by 255 and 6
    into reciprocal products, which moves the last bit of some values
    against an op-by-op run (and flips a mask pixel at threshold 0.3)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (96, 80, 3), dtype=np.uint8)
    img[:20, :20] = 128  # grey: delta 0
    img[20:30, :, 1] = img[20:30, :, 0]  # ties between channels
    hsv = jax.jit(jmask.rgb_to_hsv)
    ref = np.asarray(hsv(jnp.asarray(img)))
    got = tmask.rgb_to_hsv(T(img)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    for thr in (0.04, 0.3):
        np.testing.assert_array_equal(tmask.tissue_mask_hsv(T(img), thr).numpy(),
                                      np.asarray(jmask.tissue_mask_hsv(jnp.asarray(img), thr)))
    f = rng.random((40, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmask.rgb_to_hsv(T(f)).numpy().view(np.int32),
                                  np.asarray(hsv(jnp.asarray(f))).view(np.int32))


@pytest.mark.parametrize("op", ["binary_dilation", "binary_erosion", "binary_closing",
                                "binary_opening"])
def test_binary_morphology_matches_jax(op):
    rng = np.random.default_rng(1)
    mask = rng.random((2, 50, 70)) > 0.6
    mask[:, :5] = True  # foreground on the border
    for se in (tmorph.disk(3), tmorph.disk(1), np.ones((2, 3), np.float32)):
        np.testing.assert_array_equal(tmorph.disk(3), jmorph.disk(3))
        ref = np.asarray(getattr(jmorph, op)(jnp.asarray(mask), se))
        np.testing.assert_array_equal(getattr(tmorph, op)(T(mask), se).numpy(), ref)
        np.testing.assert_array_equal(getattr(tmorph, op)(T(mask[0]), se).numpy(), ref[0])


# ------------------------------------------------------------- resizes


@pytest.mark.parametrize("channels", [0, 3], ids=["gray", "rgb"])
def test_resize_area_equals_cv2(channels):
    rng = np.random.default_rng(2 + channels)
    shapes = [((384, 512), (288, 384)), ((300, 450), (97, 131)), ((100, 100), (50, 50)),
              ((99, 99), (33, 33)), ((100, 99), (50, 33)), ((101, 99), (50, 33)),
              ((64, 48), (16, 24)), ((70, 50), (70, 25)), ((57, 43), (57, 43))]
    shapes += [((int(h), int(w)), (int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))))
               for h, w in rng.integers(2, 300, (20, 2))]
    for (h, w), (oh, ow) in shapes:
        img = rng.integers(0, 256, (h, w, channels) if channels else (h, w), dtype=np.uint8)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(img, ow, oh), ref, err_msg=f"{(h, w, oh, ow)}")
    with pytest.raises(ValueError, match="downscales"):
        resize_area(np.zeros((4, 4), np.uint8), 8, 8)


def test_resize_nearest_equals_cv2():
    rng = np.random.default_rng(4)
    for _ in range(40):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 400, 4))
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest(img, ow, oh), ref)


def test_get_thumbnail_equals_jax(slides):
    jslide, tslide = slides
    for size in ((512, 512), (2000, 2000), (300, 300), (700, 1000)):
        np.testing.assert_array_equal(tslide.get_thumbnail(size), jslide.get_thumbnail(size))


# -------------------------------------------------------- tissue and rings


@pytest.mark.parametrize("kwargs", [{"min_size": 100}, {"min_size": 100, "max_work_dim": 384}],
                         ids=["min_size_100", "downscaled"])
def test_tissue_boundary_mask_and_rings_match_jax(slides, kwargs):
    jslide, _ = slides
    thumb = jslide.get_thumbnail((512, 512))
    ref = jpipe.tissue_boundary_mask(thumb, **kwargs)
    got = tpipe.tissue_boundary_mask(thumb, device="cpu", **kwargs)
    assert got.dtype == bool and got.shape == thumb.shape[:2]
    np.testing.assert_array_equal(got, ref)
    assert 0.02 < got.mean() < 0.95
    dim = {"max_work_dim": kwargs["max_work_dim"]} if "max_work_dim" in kwargs else {}
    ref_rings = jpipe.mask_to_thumb_polygons(ref, **dim)
    rings = tpipe.mask_to_thumb_polygons(got, device="cpu", **dim)
    assert len(rings) == len(ref_rings) >= 1
    for a, b in zip(rings, ref_rings):
        np.testing.assert_array_equal(a, b)


def test_geojson_round_trip_matches_jax(geojson_file, tmp_path):
    path, feats = geojson_file
    tart.export_geojson(tmp_path / "t.geojson", feats)
    assert (tmp_path / "t.geojson").read_text() == path.read_text()
    for a, b in zip(tart.load_geojson(path), jart.load_geojson(path)):
        assert a["class_name"] == b["class_name"]
        np.testing.assert_array_equal(a["exterior"], b["exterior"])
        assert (a["area_px2"], a["perimeter_px"]) == (b["area_px2"], b["perimeter_px"])
    ring = np.asarray(feats[3]["exterior"])
    assert tart.polygon_ring_area_perimeter(ring) == jart.polygon_ring_area_perimeter(ring)


# ------------------------------------------------------ islands, PNG, TXT


def _png_size_and_pixels(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    assert (depth, ctype) == (8, 2)
    start = data.index(b"IDAT") + 4
    n = struct.unpack(">I", data[start - 8 : start - 4])[0]
    raw = np.frombuffer(zlib.decompress(data[start : start + n]), np.uint8).reshape(h, 3 * w + 1)
    assert (raw[:, 0] == 0).all()
    return (w, h), raw[:, 1:].reshape(h, w, 3)


def test_process_one_slide_matches_jax(slides, geojson_file, tmp_path):
    jslide, tslide = slides
    path, _ = geojson_file
    groups = ([CLASSES[0]], [CLASSES[2]], [CLASSES[3]])
    ref = jpipe.process_one_slide_make_csv_and_plot(jslide, path, tmp_path / "jax", "s", *groups)
    got = tpipe.process_one_slide_make_csv_and_plot(tslide, path, tmp_path / "port", "s", *groups,
                                                    device="cpu")
    assert list(got.columns) == list(ref.columns) and len(got) == 4
    assert (tmp_path / "port" / "s_islands.csv").read_text() == \
        (tmp_path / "jax" / "s_islands.csv").read_text()
    # the PNG: the thumbnail, with the rings drawn over it
    thumb = tslide.get_thumbnail((2000, 2000))
    (w, h), px = _png_size_and_pixels(tmp_path / "port" / "s_boundaries.png")
    assert (h, w) == thumb.shape[:2]
    drawn = (px != thumb).any(-1)
    assert 0 < drawn.mean() < 0.1
    np.testing.assert_array_equal(px[~drawn], thumb[~drawn])
    for color in ((0, 0, 0), (0xD6, 0x27, 0x28), (0x2C, 0xA0, 0x2C), (0x1F, 0x77, 0xB4)):
        assert (px[drawn] == color).all(-1).any(), color
    decoded = cv2.imread(str(tmp_path / "port" / "s_boundaries.png"))[:, :, ::-1]
    np.testing.assert_array_equal(decoded, px)

    # the burden TXT, twice appended, equal but for the timestamps
    def txt(df, where):
        out = where / "m.txt"
        mod = jpipe if where.name == "jax" else tpipe
        mod.write_basic_size_burden_metrics_txt(df, "s", out)
        mod.write_basic_size_burden_metrics_txt(df.iloc[:0], "s", out)
        return [ln for ln in out.read_text().splitlines() if not ln.startswith("Timestamp:")]

    assert txt(got, tmp_path / "port") == txt(ref, tmp_path / "jax")
