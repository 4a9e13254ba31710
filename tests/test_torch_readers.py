"""The port's readers against the JAX package's on the CPU, on inputs made
from a seed with numpy: ``pipeline/plotting.py`` (``load_centroid_tsv``,
``merge_pred_tsvs``, ``class_map_from_instances``; frames and arrays
equal exactly), ``io/asap.py`` (``parse_asap_xml`` equal, the pairing of
``overlay_for_slide_dir`` equal), ``io/gdc.py`` (the payloads and
``parse_hits`` equal; the network calls through a stub of ``requests``
equal, and JAX's error without it), and ``core/artifacts.py::tiles_table``
/ ``export_tiles_csv`` over every coordinate variant
``read_tessellation_h5`` takes (frames, attrs and CSV text equal; the port
reads the H5 through its own ``io/hdf5.py``).

The two figures are the port's own drawings (no matplotlib): the file is
written under the JAX name, and the class colours (``_CLASS_COLORS``) and
tab10 group colours sit at the centroid pixels and on the polygon rings."""

import sys
import zlib

import h5py
import numpy as np
import pandas as pd
import pytest

from path_gene_multimodal_tpu.core import artifacts as jart
from path_gene_multimodal_tpu.io import asap as jasap
from path_gene_multimodal_tpu.io import gdc as jgdc
from path_gene_multimodal_tpu.pipeline import plotting as jplot
from path_gene_multimodal_tpu_torch.core import artifacts as tart
from path_gene_multimodal_tpu_torch.io import asap as tasap
from path_gene_multimodal_tpu_torch.io import gdc as tgdc
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide
from path_gene_multimodal_tpu_torch.io.tiff_write import write_tiled_tiff
from path_gene_multimodal_tpu_torch.pipeline import plotting as tplot


def _read_png(path):
    """Decode the port's PNG (8-bit RGB, filter 0 rows) into (H, W, 3)."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


# ------------------------------------------------------------- plotting


@pytest.fixture
def tsvs(tmp_path):
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 500, (12, 2)).round(2)
    (tmp_path / "pred_neoplastic.tsv").write_text(
        "x\ty\tname\n" + "".join(f"{x}\t{y}\tcell{i}\n" for i, (x, y) in enumerate(xy[:5])))
    (tmp_path / "pred_inflammatory.tsv").write_text(
        "# exported\n" + "".join(f"{x}\t{y}\tn\textra\n" for x, y in xy[5:9]))
    (tmp_path / "pred_dead.tsv").write_text(
        "Y\tX\n" + "".join(f"{y}\t{x}\n" for x, y in xy[9:]) + "bad\t1\n")
    (tmp_path / "custom.tsv").write_text("".join(f"{x}\t{y}\n" for x, y in xy[:3]))
    return tmp_path


def test_centroid_tsvs_equal_jax(tsvs):
    for f in sorted(tsvs.glob("*.tsv")):
        pd.testing.assert_frame_equal(tplot.load_centroid_tsv(f), jplot.load_centroid_tsv(f))
    for pattern in ("pred_*.tsv", "*.tsv", "none_*.tsv"):
        pd.testing.assert_frame_equal(tplot.merge_pred_tsvs(tsvs, pattern),
                                      jplot.merge_pred_tsvs(tsvs, pattern))


def test_class_map_equal_jax():
    rng = np.random.default_rng(4)
    inst = rng.integers(0, 30, (64, 48)).astype(np.int32)
    types = {str(k): [int(rng.integers(1, 6)), 0.9] for k in range(1, 30, 2)}
    types.update({k: 3 for k in (2, 4)}, **{"99": [5]})  # plain ints, an id past the map
    got, want = tplot.class_map_from_instances(inst, types), jplot.class_map_from_instances(
        inst, types)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    empty = np.zeros((0, 0), np.int32)
    assert np.array_equal(tplot.class_map_from_instances(empty, {}),
                          jplot.class_map_from_instances(empty, {}))


def test_plot_class_centroids_draws_class_colours(tsvs, tmp_path):
    df = tplot.merge_pred_tsvs(tsvs)
    out = tplot.plot_class_centroids(df, tmp_path / "centroids.png")
    assert out == tmp_path / "centroids.png"
    img = _read_png(out)
    rgb = {"neoplastic": (214, 39, 40), "inflammatory": (44, 160, 44), "dead": (127, 127, 127)}
    for name, (r, g, b) in rgb.items():
        for x, y in df.loc[df["class_name"] == name, ["x", "y"]].to_numpy():
            assert tuple(img[int(round(y)), int(round(x))]) == (r, g, b), (name, x, y)
    assert tuple(img[0, img.shape[1] - 1]) in {(255, 255, 255), *rgb.values()}
    # over a background: its pixels, an unknown class black
    bg = np.full((600, 600), 200, np.uint8)
    pts = pd.DataFrame({"x": [10.0, 300.4], "y": [20.0, 100.6], "class_name": ["x", "dead"]})
    img = _read_png(tplot.plot_class_centroids(pts, tmp_path / "bg.png", background=bg,
                                               point_size=5))
    assert img.shape == (600, 600, 3)
    assert tuple(img[20, 10]) == (0, 0, 0) and tuple(img[101, 300]) == (127, 127, 127)
    assert tuple(img[101, 302]) == (127, 127, 127) and tuple(img[101, 304]) == (200, 200, 200)
    # a cohort-scale extent is drawn on a canvas of at most CANVAS_PX a side
    big = pd.DataFrame({"x": [0.0, 90_000.0], "y": [0.0, 40_000.0], "class_name": ["dead"] * 2})
    img = _read_png(tplot.plot_class_centroids(big, tmp_path / "big.png"))
    assert max(img.shape[:2]) <= tplot.CANVAS_PX and tuple(img[-1, -1]) == (127, 127, 127)


# ----------------------------------------------------------------- ASAP


def _asap_xml(rng, groups):
    anns = []
    for i, g in enumerate(groups):
        pts = rng.uniform(100, 900, (6, 2)).round(1)
        order = rng.permutation(6)
        coords = "".join(f'<Coordinate Order="{o}" X="{x}" Y="{y}"/>'
                         for o, (x, y) in zip(order, pts))
        anns.append(f'<Annotation Name="a{i}" PartOfGroup="{g}" Type="Polygon">'
                    f"<Coordinates>{coords}</Coordinates></Annotation>")
    anns.append('<Annotation Name="short"><Coordinates><Coordinate Order="0" X="1" Y="2"/>'
                '<Coordinate Order="1" X="bad" Y="2"/></Coordinates></Annotation>')
    anns.append('<Annotation Name="nocoords" PartOfGroup="x"/>')
    return ("<ASAP_Annotations><Annotations>" + "".join(anns)
            + "</Annotations></ASAP_Annotations>")


def test_parse_asap_xml_equal_jax(tmp_path):
    p = tmp_path / "a.xml"
    p.write_text(_asap_xml(np.random.default_rng(5), ["tumor", "stroma", "tumor"]))
    got, want = tasap.parse_asap_xml(p), jasap.parse_asap_xml(p)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k != "coords"} == {
            k: v for k, v in b.items() if k != "coords"}
        assert a["coords"].dtype == b["coords"].dtype and np.array_equal(a["coords"], b["coords"])


def test_overlay_for_slide_dir_pairs_as_jax(tmp_path):
    rng = np.random.default_rng(6)
    slides, xmls = tmp_path / "slides", tmp_path / "xml"
    slides.mkdir(), xmls.mkdir()
    img = np.full((1024, 1024, 3), 230, np.uint8)
    for stem in ("case_a", "case_b", "case_c"):
        write_tiled_tiff(slides / f"{stem}.tif", [img], tile_size=256, compression=8)
    (xmls / "case_a.xml").write_text(_asap_xml(rng, ["tumor", "stroma"]))
    (xmls / "case_c.xml").write_text(_asap_xml(rng, ["tumor"]))
    (xmls / "orphan.xml").write_text(_asap_xml(rng, ["tumor"]))
    got = tasap.overlay_for_slide_dir(slides, xmls, tmp_path / "port", thumb_size=(512, 512))
    want = jasap.overlay_for_slide_dir(slides, xmls, tmp_path / "jax", thumb_size=(512, 512))
    assert sorted(got) == sorted(want) == ["case_a", "case_c"]
    assert all(got[k].name == want[k].name == f"{k}_annotation_overlay.png" for k in got)
    # the rings: tab10 by sorted group ("stroma" blue, "tumor" orange), 1 px
    anns = tasap.parse_asap_xml(xmls / "case_a.xml")
    out = _read_png(got["case_a"])
    assert out.shape == (512, 512, 3)
    for a in anns:
        x, y = np.rint(a["coords"][0] * 0.5).astype(int)
        assert tuple(out[y, x]) == tasap.TAB10[["stroma", "tumor"].index(a["group"])]
    single = _read_png(tasap.overlay_asap_annotations(
        ArraySlide(img), xmls / "case_a.xml", tmp_path / "one.png", thumb_size=(512, 512),
        color_by_group=False))
    assert {tuple(v) for v in single.reshape(-1, 3)} == {(230, 230, 230), tasap.SINGLE_COLOR}


# ------------------------------------------------------------------ GDC


class _Response:
    def __init__(self, payload=None, chunks=()):
        self.payload, self.chunks = payload, chunks

    def raise_for_status(self):
        pass

    def json(self):
        return self.payload

    def iter_content(self, chunk_size):
        yield from self.chunks

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Requests:
    """Records each call and answers from canned GDC payloads."""

    def __init__(self):
        self.calls = []

    def get(self, url, params=None, timeout=None, stream=False):
        self.calls.append((url, params, timeout, stream))
        if url.endswith("/cases"):
            return _Response({"data": {"hits": [{"case_id": "c1"}, {"case_id": "c2"}]}})
        if url.endswith("/files"):
            case = params["filters"]
            return _Response({"data": {"hits": [
                {"file_id": f"f-{case[-8:-6]}", "file_name": f"{len(case)}.svs"}]}})
        return _Response(chunks=[b"abc", b"def"])


def test_gdc_payloads_and_parse_equal_jax():
    for project, size in (("TCGA-LUAD", 200), ("TCGA-BRCA", 7)):
        assert tgdc.cases_query_payload(project, size) == jgdc.cases_query_payload(project, size)
    assert tgdc.files_query_payload("abc", 3) == jgdc.files_query_payload("abc", 3)
    for resp in ({"data": {"hits": [{"a": 1}]}}, {"data": {}}, {}):
        assert tgdc.parse_hits(resp) == jgdc.parse_hits(resp)
    assert (tgdc.GDC_CASES, tgdc.GDC_FILES, tgdc.GDC_DATA) == (
        jgdc.GDC_CASES, jgdc.GDC_FILES, jgdc.GDC_DATA)


def test_gdc_network_calls_through_requests_stub(monkeypatch, tmp_path):
    results = {}
    for name, mod in (("port", tgdc), ("jax", jgdc)):
        stub = _Requests()
        monkeypatch.setattr(mod, "_requests", lambda stub=stub: stub)
        paths = mod.download_project_slides("TCGA-LUAD", tmp_path / name, max_cases=2)
        again = mod.download_file("f-x", paths[0].name, tmp_path / name)  # skip if it exists
        results[name] = ([p.name for p in paths], [p.read_bytes() for p in paths], stub.calls,
                         again == paths[0])
    assert results["port"] == results["jax"]
    assert results["port"][1] == [b"abcdef", b"abcdef"] and results["port"][3]


def test_gdc_without_requests_raises_jax_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "requests", None)
    errors = []
    for mod in (tgdc, jgdc):
        with pytest.raises(RuntimeError) as e:
            mod.list_case_ids()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "requests" in errors[0]


# ----------------------------------------------------------- tiles table

COORDS = np.random.default_rng(8).integers(0, 40_000, (9, 2)).astype(np.int64)


def _variant(path, name):
    """One of the coordinate layouts ``read_tessellation_h5`` takes, with
    the attrs ``tiles_table`` reads."""
    with h5py.File(path, "w") as f:
        if name in ("coords", "locations", "tiles/coords", "some/odd/patch_coords"):
            d = f.create_dataset(name, data=COORDS)
            d.attrs["patch_size"] = 224
            f.attrs["mpp"] = 0.25
            f.attrs["slide_id"] = "TCGA-XX.1"
        elif name in ("x/y", "tiles/x/tiles/y"):
            xk, yk = ("x", "y") if name == "x/y" else ("tiles/x", "tiles/y")
            d = f.create_dataset(xk, data=COORDS[:, 0])
            f.create_dataset(yk, data=COORDS[:, 1])
            d.attrs["tile_size"] = 256
            f.attrs["stride"] = 256
        elif name == "flat":
            f.create_dataset("coords", data=COORDS.reshape(-1))
            f.attrs["size"] = 512
        elif name == "level_col":
            c3 = np.c_[COORDS, np.arange(9) % 3]
            f.create_dataset("coords", data=c3)
            f.attrs["downsample"] = 4.0
        elif name == "xywh":
            f.create_dataset("coords", data=np.c_[COORDS, np.full((9, 2), 300)])
            f.attrs["level"] = 1
        elif name == "columns_attr":
            d = f.create_dataset("coords", data=np.c_[np.arange(9) % 2, COORDS])
            d.attrs["columns"] = ["level", "x", "y"]
        elif name == "level_dataset":
            f.create_dataset("coords", data=COORDS)
            f.create_dataset("level", data=np.arange(9) % 4)
        elif name == "wide":
            f.create_dataset("coords", data=np.c_[COORDS, COORDS, COORDS[:, :1]])


@pytest.mark.parametrize("name", ["coords", "locations", "tiles/coords", "some/odd/patch_coords",
                                  "x/y", "tiles/x/tiles/y", "flat", "level_col", "xywh",
                                  "columns_attr", "level_dataset", "wide"])
def test_tiles_table_equal_jax(tmp_path, name):
    p = tmp_path / "slide.v1.h5"
    _variant(p, name)
    got, got_attrs = tart.tiles_table(p)
    want, want_attrs = jart.tiles_table(p)
    pd.testing.assert_frame_equal(got, want)
    assert sorted(got_attrs) == sorted(want_attrs)
    for k in want_attrs:
        assert np.array_equal(np.asarray(got_attrs[k]), np.asarray(want_attrs[k])), k
    out_t = tart.export_tiles_csv(p, tmp_path / "port.csv")
    out_j = jart.export_tiles_csv(p, tmp_path / "jax.csv")
    assert out_t.read_text() == out_j.read_text()
    assert tart.export_tiles_csv(p).name == "slide.v1.tiles.csv"


def test_tiles_table_refuses_as_jax(tmp_path):
    p = tmp_path / "none.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("unrelated", data=np.arange(5))
    for mod in (tart, jart):
        with pytest.raises(ValueError, match="no tile-coordinate dataset"):
            mod.tiles_table(p)
