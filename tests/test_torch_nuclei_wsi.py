"""The port's sliding-window nuclei mode (``pipeline/nuclei_wsi.py``)
against the JAX package's, on the CPU: the window grid and containment
helpers, the seam dedup, the fake-model cases of
``tests/test_fusion_wsi.py`` and ``tests/test_sparse_d2h.py`` through both
packages (tables and maps, npz and zip, identical), a JPEG TIFF with an odd
side where both feed routes occur, and the sparse packs, which must not
wait for the device."""

import numpy as np
import pandas as pd
import pytest
import torch

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.io.slide import ArraySlide as JArraySlide
from path_gene_multimodal_tpu.io.slide import synthetic_wsi as j_synthetic_wsi
from path_gene_multimodal_tpu.pipeline import nuclei_wsi as jw
from path_gene_multimodal_tpu_torch.config import HoverNeXtConfig, default_config
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide, synthetic_wsi
from path_gene_multimodal_tpu_torch.ops import instances as ti
from path_gene_multimodal_tpu_torch.pipeline import nuclei_wsi as tw
from test_fusion_wsi import StripeFakeModel
from test_sparse_d2h import _DenseFake


class _TorchFake:
    """The port's counterpart of a JAX fake segmenter: ``segment_async``
    on a (B, S, S, 3) uint8 tensor → (labels int32, types uint8) tensors,
    from the JAX fake's own numpy ``segment``."""

    def __init__(self, jfake):
        self._j = jfake
        self.cfg = HoverNeXtConfig(input_size=jfake.cfg.input_size)
        self.max_instances = jfake.max_instances
        self.device = torch.device("cpu")

    def cc_overflow_tiles(self, reset: bool = False) -> int:
        return 0

    def segment_async(self, tiles_u8: torch.Tensor):
        inst, types = self._j.segment(tiles_u8.cpu().numpy())
        return (torch.from_numpy(np.asarray(inst, np.int32)),
                torch.from_numpy(np.asarray(types).astype(np.uint8)))


FLOAT_EXACTISH = ["centroid_x", "centroid_y", "wsi_centroid_x", "wsi_centroid_y",
                  "perimeter", "solidity"]


def assert_wsi_tables_match(jt: pd.DataFrame, tt: pd.DataFrame, jdir, tdir) -> None:
    """Row for row, in order: every integer, string and list column equal
    (``nuc_id`` aside; ``tile_path`` relative to its output directory), so a
    window or owner that flips shows; the float columns at
    ``tests/test_torch_nuclei_slice.py``'s tolerances. Eccentricity,
    sqrt(1 - minor² / major²), has an unbounded slope at 0: on a square
    (exactly 0, as the port's integer moments give it) the JAX package's f32
    moments read 0.004-0.005. Below 0.05 it is held as its square, the
    smooth quantity, at 1e-4."""
    assert len(tt) == len(jt)
    assert list(tt.columns) == list(jt.columns)
    if len(jt) == 0:
        return
    for col in jt.columns:
        if col in ("nuc_id", "orientation", "eccentricity", "major_axis_length",
                   "minor_axis_length") or col in FLOAT_EXACTISH:
            continue
        if col == "tile_path":
            assert [p.replace(str(tdir), "") for p in tt[col]] == \
                [p.replace(str(jdir), "") for p in jt[col]]
            continue
        assert tt[col].tolist() == jt[col].tolist(), col
    for col in FLOAT_EXACTISH:
        np.testing.assert_allclose(tt[col], jt[col], rtol=1e-5, atol=1e-4, err_msg=col)
    je, te = jt["eccentricity"].to_numpy(), tt["eccentricity"].to_numpy()
    round_ = je < 0.05
    np.testing.assert_allclose(te[~round_], je[~round_], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(te[round_] ** 2, je[round_] ** 2, rtol=0, atol=1e-4)
    for col in ["major_axis_length", "minor_axis_length"]:
        np.testing.assert_allclose(tt[col], jt[col], rtol=2e-3, atol=2e-3, err_msg=col)
    sel = je > 0.5
    d = np.abs(tt["orientation"].to_numpy() - jt["orientation"].to_numpy())
    d = np.minimum(d, np.abs(d - np.pi))
    assert (d[sel] < 0.02).all()


def assert_maps_match(jdir, tdir, stem: str, zipped: bool = True) -> np.ndarray:
    jm = jw.load_instance_map(jdir / f"{stem}_pinst_pp.npz")
    tm = tw.load_instance_map(tdir / f"{stem}_pinst_pp.npz")
    assert tm.dtype == jm.dtype == np.uint32
    np.testing.assert_array_equal(tm, jm)
    with np.load(tdir / f"{stem}_pinst_pp.npz") as t, np.load(jdir / f"{stem}_pinst_pp.npz") as j:
        assert sorted(t.files) == sorted(j.files)
    assert (tdir / f"{stem}_pinst_pp.zip").exists() == zipped
    assert (jdir / f"{stem}_pinst_pp.zip").exists() == zipped
    if zipped:
        tz = tw.load_instance_map(tdir / f"{stem}_pinst_pp.zip")
        np.testing.assert_array_equal(tz, tm)
        np.testing.assert_array_equal(jw.load_instance_map(tdir / f"{stem}_pinst_pp.zip"), tm)
        np.testing.assert_array_equal(tw.load_instance_map(jdir / f"{stem}_pinst_pp.zip"), jm)
    return tm


def _both(tmp_path, jslide, tslide, jfake, stem, batch_size=4):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jpath, jt = jw.run_hovernext_wsi(jslide, jdir, stem, jfake, j_default_config(),
                                     batch_size=batch_size)
    tpath, tt = tw.run_hovernext_wsi(tslide, tdir, stem, _TorchFake(jfake), default_config(),
                                     batch_size=batch_size)
    assert (jpath is None) == (tpath is None)
    assert_wsi_tables_match(jt, tt, jdir, tdir)
    return jdir, tdir, jt, tt


def _squares(h, w, boxes):
    img = np.full((h, w, 3), 30, np.uint8)
    for y0, y1, x0, x1 in boxes:
        img[y0:y1, x0:x1] = [255, 0, 0]
    return img


@pytest.mark.parametrize("case", ["dedup", "seam", "edge_seam"])
def test_fake_cases_match_jax(tmp_path, case):
    """tests/test_fusion_wsi.py's dedup, seam straddler and edge + seam
    straddler cases."""
    img, n = {
        "dedup": (_squares(600, 1000, [(100, 110, 120, 130), (400, 410, 700, 710)]), 2),
        "seam": (_squares(400, 800, [(200, 210, 237, 267)]), 1),
        "edge_seam": (_squares(400, 1300, [(0, 20, 988, 1012)]), 1),
    }[case]
    jdir, tdir, jt, tt = _both(tmp_path, JArraySlide(img), ArraySlide(img), StripeFakeModel(), "w")
    assert len(tt) == n
    assert tt["inst_id"].tolist() == list(range(1, n + 1))
    m = assert_maps_match(jdir, tdir, "w")
    assert set(np.unique(m)) == set(range(n + 1))
    assert (tdir / "w_hovernet_nuclei_wsi.parquet").exists()
    assert tt.attrs["feed_routes"] == {"planar": 0, "rgb": -(-len(
        tw.iter_windows(img.shape[1], img.shape[0], 256, 248)) // 4)}


def test_sparse_map_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jw, "DENSE_MAP_MAX_PIXELS", 10)
    monkeypatch.setattr(tw, "DENSE_MAP_MAX_PIXELS", 10)
    img = _squares(300, 300, [(100, 110, 100, 110)])
    jdir, tdir, _, tt = _both(tmp_path, JArraySlide(img), ArraySlide(img), StripeFakeModel(),
                              "sp")
    assert len(tt) == 1
    with np.load(tdir / "sp_pinst_pp.npz") as z:
        assert "inst_map" not in z and len(z["ids"]) == 100
    m = assert_maps_match(jdir, tdir, "sp", zipped=False)
    assert (m == 1).sum() == 100 and m[104, 104] == 1


def test_overflow_dense_refetch_matches_jax(tmp_path):
    """tests/test_sparse_d2h.py's overflow case: ~15% nonzero windows
    overflow the first label budget at batch 4; the batch copies its dense
    labels, later batches pack at the next rung, and the output is the
    JAX package's."""
    jslide = j_synthetic_wsi(760, 760, seed=3)
    tslide = synthetic_wsi(760, 760, seed=3)
    jdir, tdir, _, tt = _both(tmp_path, jslide, tslide, _DenseFake(), "s")
    assert len(tt) > 0 and (tt["area"] == 10000.0).all() and (tt["type"] == 2).all()
    m = assert_maps_match(jdir, tdir, "s")
    _, counts = np.unique(m[m > 0], return_counts=True)
    assert len(counts) == len(tt) and (counts == 10000).all()
    # 16 windows, 4 batches of 40,000 px: batch 2 is packed before batch 1's
    # count is read, so both overflow the first rung (8,192); batch 3
    # overflows the second (32,768); batch 4 fits the third
    assert tt.attrs["sparse_budget_levels"]["labels"] == 2
    assert tt.attrs["transport"]["dense_label_batches"] == 3


def test_odd_sided_tiff_both_routes_match_jax(tmp_path):
    """A 1001 x 600 JPEG TIFF written by the port (its bytes equal the JAX
    writer's): the window at x = 745 is odd, so its chunks take the RGB
    route and the even ones the planar route, in both packages."""
    from path_gene_multimodal_tpu.io.tiff import TiffTileSlide as JTiff
    from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide
    from path_gene_multimodal_tpu_torch.io.tiff_write import write_tiled_tiff

    img = np.full((600, 1001, 3), 30, np.uint8)
    for y0, x0 in [(40, 60), (300, 250), (100, 760), (520, 940), (250, 500)]:
        img[y0:y0 + 14, x0:x0 + 12] = [250, 20, 30]
    tif = write_tiled_tiff(tmp_path / "odd.svs", [img], tile_size=256, compression=7,
                           description="Aperio |MPP = 0.25|")
    tslide = TiffTileSlide(tif)
    jdir, tdir, jt, tt = _both(tmp_path, JTiff(tif), tslide, StripeFakeModel(), "odd")
    windows = tw.iter_windows(1001, 600, 256, 248)
    chunks = [windows[s:s + 4] for s in range(0, len(windows), 4)]
    odd = sum(any(x % 2 or y % 2 for x, y in c) for c in chunks)
    assert 0 < odd < len(chunks)
    assert tt.attrs["feed_routes"] == {"planar": len(chunks) - odd, "rgb": odd}
    assert len(tt) == 5 and tslide.decoder_refusals == 0
    assert_maps_match(jdir, tdir, "odd")


@pytest.mark.parametrize("w,h", [(100, 100), (256, 256), (257, 255), (1000, 600), (1001, 599),
                                 (6144, 6144), (2047, 2049), (504, 760)])
def test_window_grid_matches_jax(w, h):
    windows = tw.iter_windows(w, h, 256, 248)
    assert windows == jw.iter_windows(w, h, 256, 248)
    assert tw.iter_windows(w, h, 128, 124) == jw.iter_windows(w, h, 128, 124)
    xs, ys = sorted({x for x, _ in windows}), sorted({y for _, y in windows})
    rng = np.random.default_rng(w * 7 + h)
    for grid, side in ((xs, w), (ys, h)):
        for lo in rng.uniform(-2, side + 2, 40):
            hi = lo + rng.uniform(0, 60)
            for lo_, hi_ in ((lo, hi), (float(int(lo)), float(int(hi)))):
                assert tw.axis_candidates(lo_, hi_, grid, 256) == \
                    jw.axis_candidates(lo_, hi_, grid, 256)
                for g in grid:
                    assert tw.contains_1d(lo_, hi_, g, grid, 256) == \
                        jw.contains_1d(lo_, hi_, g, grid, 256)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_seam_duplicates_matches_jax(seed):
    """Seeded rows: nuclei seen whole, and clipped views of them (a
    sub-box with a biased centroid) beside distinct close neighbours."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(60):
        cx, cy = rng.uniform(0, 600, 2)
        r = rng.uniform(3, 12)
        box = [cx - r, cy - r, cx + r, cy + r]
        rows.append({"wsi_centroid_x": cx, "wsi_centroid_y": cy, "wsi_bbox_xmin": box[0],
                     "wsi_bbox_ymin": box[1], "wsi_bbox_xmax": box[2], "wsi_bbox_ymax": box[3],
                     "area": float(np.pi * r * r), "_clipped": bool(rng.random() < 0.3), "k": i})
        for _ in range(int(rng.integers(0, 3))):  # clipped views of this nucleus
            cut = rng.uniform(0.2, 0.8)
            vbox = [box[0], box[1], box[0] + cut * 2 * r, box[3]] if rng.random() < 0.5 else \
                [box[0], box[1], box[2], box[1] + cut * 2 * r]
            rows.append({"wsi_centroid_x": (vbox[0] + vbox[2]) / 2 + rng.normal(0, 1),
                         "wsi_centroid_y": (vbox[1] + vbox[3]) / 2 + rng.normal(0, 1),
                         "wsi_bbox_xmin": vbox[0], "wsi_bbox_ymin": vbox[1],
                         "wsi_bbox_xmax": vbox[2], "wsi_bbox_ymax": vbox[3],
                         "area": float(np.pi * r * r * cut), "_clipped": True, "k": 1000 + i})
    order = rng.permutation(len(rows))
    rows = [rows[i] for i in order]
    got = [r["k"] for r in tw._dedup_seam_duplicates([dict(r) for r in rows])]
    want = [r["k"] for r in jw._dedup_seam_duplicates([dict(r) for r in rows])]
    assert got == want and 0 < len(got) < len(rows)


def test_packs_do_not_wait_for_the_device(monkeypatch):
    """No call that reads a value back to the host (``torch.cuda.synchronize``,
    ``Tensor.item`` / ``tolist`` / ``__bool__`` / ``__int__`` / ``numpy``,
    ``torch.nonzero``, a boolean index) runs while the two packs run on a
    batch."""
    lbl = torch.from_numpy(
        __import__("test_sparse_d2h")._random_labels(np.random.default_rng(5), b=4))
    feats = ti.instance_features_batch(lbl, (lbl > 0).to(torch.int32) * 3, max_instances=32)
    seen = []

    def spy(name, real):
        def f(*a, **k):
            seen.append(name)
            return real(*a, **k)
        return f

    real_getitem = torch.Tensor.__getitem__

    def getitem(self, key):
        keys = key if isinstance(key, tuple) else (key,)
        if any(isinstance(k, torch.Tensor) and k.dtype == torch.bool for k in keys):
            seen.append("boolean index")
        return real_getitem(self, key)

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", spy("synchronize", torch.cuda.synchronize))
        m.setattr(torch, "nonzero", spy("nonzero", torch.nonzero))
        for name in ("item", "tolist", "__bool__", "__int__", "numpy", "nonzero"):
            m.setattr(torch.Tensor, name, spy(name, getattr(torch.Tensor, name)))
        m.setattr(torch.Tensor, "__getitem__", getitem)
        out = (ti.pack_labels_sparse(lbl, 4096), ti.pack_features_sparse(feats, 64))
    assert seen == []
    assert int(out[0][0]) == int((lbl != 0).sum()) and int(out[1][0]) > 0


class _BorderShyFake:
    """A segmenter whose view of a nucleus depends on the window, as a CNN's
    does near a border: a red + magenta blob is one instance, unless it
    touches the window's right edge, where only its red core is found."""

    def __init__(self):
        from path_gene_multimodal_tpu.models.hovernext import HoverNeXtConfig as JCfg

        self.cfg = JCfg(input_size=256)
        self.max_instances = 16

    def segment(self, tiles_u8):
        t = np.asarray(tiles_u8)
        inst = np.zeros(t.shape[:3], np.int32)
        for bi in range(t.shape[0]):
            blob = t[bi, :, :, 0] > 200
            if blob[:, -1].any():
                blob &= t[bi, :, :, 2] < 100
            inst[bi][blob] = 1
        return inst, (inst > 0).astype(np.int32)


@pytest.mark.parametrize("map_kind", ["dense", "sparse", "none"])
def test_row_hidden_under_a_later_row_is_dropped(tmp_path, monkeypatch, map_kind):
    """Window 0 sees only the red core of a blob that runs past its right
    edge (a clean fragment); window 44 sees the whole blob (clean too). The
    JAX package keeps both rows, and the whole blob's pixels overwrite the
    fragment's, so its map lacks id 1. The port drops the hidden row and
    compacts the ids: the rest equals the JAX output, and every row owns a
    map pixel, whether the map is dense, sparse or not written."""
    img = np.full((256, 300, 3), 30, np.uint8)
    img[100:120, 200:220] = [255, 0, 0]
    img[100:120, 220:290] = [255, 0, 255]
    if map_kind == "sparse":
        monkeypatch.setattr(jw, "DENSE_MAP_MAX_PIXELS", 10)
        monkeypatch.setattr(tw, "DENSE_MAP_MAX_PIXELS", 10)
    fake = _BorderShyFake()
    jpath, jt = jw.run_hovernext_wsi(JArraySlide(img), tmp_path / "j", "h", fake,
                                     j_default_config(), batch_size=4)
    tpath, tt = tw.run_hovernext_wsi(ArraySlide(img), tmp_path / "t", "h", _TorchFake(fake),
                                     default_config(), batch_size=4,
                                     write_instance_map=map_kind != "none")
    assert jt["tile_x"].tolist() == [0, 44] and jt["area"].tolist() == [400.0, 1800.0]
    jm = jw.load_instance_map(jpath)
    assert set(np.unique(jm)) == {0, 2}  # the JAX map lacks row 1
    assert tt.attrs["hidden_rows_dropped"] == 1 and tt["inst_id"].tolist() == [1]
    want = jt.iloc[1:].copy()
    want["inst_id"] = [1]
    assert_wsi_tables_match(want.reset_index(drop=True), tt, tmp_path / "j", tmp_path / "t")
    if map_kind == "none":
        assert tpath is None
    else:
        np.testing.assert_array_equal(tw.load_instance_map(tpath), (jm == 2).astype(np.uint32))
