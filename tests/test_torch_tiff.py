"""The port's slide reader (``io/tiff.py::TiffTileSlide``), writer
(``io/tiff_write.py``) and ``open_slide`` against the JAX package's, on
the CPU: the same files (written by the JAX writer) read to equal pixels
through every surface (regions at every level, tile batches, prefetch,
thumbnails one-shot and in bands, associated images, planar regions),
striped pages, BigTIFF, predictor 2, LZW, PackBits, J2K, memoized planar
failures, the cache budgets, malformed headers that must raise; the
port's writer byte-identical to the JAX writer for raw, deflate and JPEG;
and the tiles the port's decoder refuses going through PIL, counted."""

import struct

import numpy as np
import pytest

from path_gene_multimodal_tpu.io import tiff as jtiff
from path_gene_multimodal_tpu.io.slide import open_slide as j_open_slide
from path_gene_multimodal_tpu.io.tiff import TiffTileSlide as JSlide
from path_gene_multimodal_tpu.io.tiff_write import write_striped_tiff as j_write_striped
from path_gene_multimodal_tpu.io.tiff_write import write_tiff_pages as j_write_pages
from path_gene_multimodal_tpu.io.tiff_write import write_tiled_tiff as j_write_tiled
from path_gene_multimodal_tpu_torch.io import tiff as ttiff
from path_gene_multimodal_tpu_torch.io import tiff_write as twrite
from path_gene_multimodal_tpu_torch.io.slide import open_slide, synthetic_wsi
from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide


@pytest.fixture(scope="module")
def tissue():
    """A 1024 x 768 synthetic H&E level 0 (tissue, nuclei, background)."""
    return synthetic_wsi(1024, 768, seed=3, n_blobs=3, nuclei_per_blob=150)._levels[0]


def _both(path, **kw):
    return JSlide(path, **kw), TiffTileSlide(path, **kw)


def _regions_equal(j, t, regions):
    for loc, level, size in regions:
        np.testing.assert_array_equal(t.read_region(loc, level, size),
                                      j.read_region(loc, level, size), err_msg=str(loc))


@pytest.mark.parametrize("compression", [7, 8, 1])
def test_tiled_pyramid_matches_jax(tmp_path, tissue, compression):
    levels = [tissue, tissue[::2, ::2], tissue[::4, ::4]]
    p = j_write_tiled(tmp_path / "s.svs", levels, tile_size=256, compression=compression,
                      description="Aperio fake |MPP = 0.2520|")
    j, t = _both(p)
    assert t.level_dimensions == j.level_dimensions == [(1024, 768), (512, 384), (256, 192)]
    assert t.level_downsamples == j.level_downsamples and t.mpp == j.mpp == 0.252
    _regions_equal(j, t, [((0, 0), 0, (1024, 768)), ((100, 60), 0, (300, 200)),
                          ((900, 700), 0, (300, 300)), ((100, 100), 1, (200, 200)),
                          ((-20, 8), 2, (100, 80))])
    ids = np.arange(len(t._pages[0].offsets))
    np.testing.assert_array_equal(t.read_tiles_batch(0, ids), j.read_tiles_batch(0, ids))
    assert t.get_best_level_for_downsample(3.0) == j.get_best_level_for_downsample(3.0) == 1
    for size in ((300, 300), (1000, 1000), (97, 61)):
        np.testing.assert_array_equal(t.get_thumbnail(size), j.get_thumbnail(size))
    assert t.decoder_refusals == 0


def test_prefetch_and_cache_match_jax(tmp_path, tissue):
    p = j_write_tiled(tmp_path / "pf.svs", [tissue], tile_size=256, compression=7)
    j, t = _both(p)
    assert t.prefetch_regions(np.array([[100, 100]]), 0, (300, 300)) == 4
    assert t.prefetch_regions(np.array([[100, 100]]), 0, (300, 300)) == 0
    _regions_equal(j, t, [((100, 100), 0, (300, 300))])
    t2 = TiffTileSlide(p)
    assert t2.prefetch_regions(np.array([[0, 0], [500, 300]]), 0, (100, 100)) <= 5


def test_thumbnail_bands_match_jax(tmp_path, monkeypatch):
    img = np.random.default_rng(4).integers(0, 255, (600, 800, 3), np.uint8)
    p = j_write_tiled(tmp_path / "one.tif", [img], tile_size=256)
    j, t = _both(p)
    monkeypatch.setattr(jtiff, "_THUMB_ONESHOT_BYTES", 1 << 18)
    monkeypatch.setattr(ttiff, "_THUMB_ONESHOT_BYTES", 1 << 18)
    for size in ((200, 200), (333, 250)):
        np.testing.assert_array_equal(t.get_thumbnail(size), j.get_thumbnail(size))


@pytest.mark.parametrize("compression", [33003, 33005])
def test_jpeg2000_through_pil(tmp_path, compression):
    rng = np.random.default_rng(5)
    base = np.kron(rng.integers(30, 225, size=(12, 10, 3), dtype=np.uint8),
                   np.ones((64, 64, 1), np.uint8))
    levels = [base, base[::2, ::2]]
    for write in (j_write_tiled, twrite.write_tiled_tiff):
        p = write(tmp_path / f"{write.__module__}.svs", levels, tile_size=256,
                  compression=compression)
        t = TiffTileSlide(p)
        np.testing.assert_array_equal(t.read_region((128, 192), 0, (384, 320)),
                                      base[192:512, 128:512])
        np.testing.assert_array_equal(t.read_region((100, 100), 1, (200, 200)),
                                      levels[1][50:250, 50:250])
        assert t._tile_bytes(t._pages[0], 0)[:4] == b"\xff\x4f\xff\x51"


def test_striped_pages_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (333, 420, 3), np.uint8)
    p = j_write_striped(tmp_path / "s.tif", [base, base[::2, ::2]], rows_per_strip=64,
                        compression=8, description="striped |MPP = 0.5|")
    j, t = _both(p)
    assert t._pages[0].is_strips and t.level_dimensions == j.level_dimensions
    _regions_equal(j, t, [((0, 0), 0, (420, 333)), ((50, 60), 0, (100, 200)),
                          ((40, 40), 1, (80, 90))])
    np.testing.assert_array_equal(t.read_region((0, 0), 0, (420, 333)), base)
    np.testing.assert_array_equal(t.read_tiles_batch(0, np.array([0, 5])),
                                  j.read_tiles_batch(0, np.array([0, 5])))
    assert not t.supports_planar(0)
    smooth = np.kron(rng.integers(40, 215, size=(10, 12, 3), dtype=np.uint8),
                     np.ones((32, 32, 1), np.uint8))
    pj = j_write_striped(tmp_path / "sj.tif", [smooth], rows_per_strip=48, compression=7,
                         jpeg_quality=95)
    j, t = _both(pj)
    _regions_equal(j, t, [((0, 0), 0, (384, 320))])


def test_mixed_layout_and_associated_images_match_jax(tmp_path):
    rng = np.random.default_rng(17)
    base = rng.integers(0, 255, (512, 768, 3), np.uint8)
    specs = [
        {"img": base, "layout": "tiled", "tile_size": 256, "compression": 7,
         "description": "Aperio mixed |MPP = 0.25|"},
        {"img": base[::4, ::4], "layout": "striped", "rows_per_strip": 32},
        {"img": base[::2, ::2], "layout": "tiled", "tile_size": 256},
        {"img": np.full((96, 200, 3), 40, np.uint8), "layout": "striped",
         "rows_per_strip": 96, "compression": 7, "description": "Aperio label 200x96"},
    ]
    p = j_write_pages(tmp_path / "mixed.svs", specs)
    assert twrite.write_tiff_pages(tmp_path / "mixed_t.svs", specs).read_bytes() == p.read_bytes()
    j, t = _both(p)
    assert t.level_dimensions == j.level_dimensions == [(768, 512), (384, 256)]
    assert t.associated_image_names == j.associated_image_names == ["thumbnail", "label"]
    for name in t.associated_image_names:
        np.testing.assert_array_equal(t.read_associated_image(name),
                                      j.read_associated_image(name))
    _regions_equal(j, t, [((100, 100), 0, (200, 150))])


def test_bigtiff_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, (512, 768, 3), np.uint8)
    specs = [{"img": base, "layout": "tiled", "tile_size": 256,
              "description": "BigTIFF fixture |MPP = 0.3|"},
             {"img": base[::2, ::2], "layout": "tiled", "tile_size": 256, "compression": 7},
             {"img": base[:150, :200], "layout": "striped", "rows_per_strip": 192}]
    p = j_write_pages(tmp_path / "big.tif", specs, bigtiff=True)
    assert p.read_bytes()[2:4] == b"+\x00"
    assert twrite.write_tiff_pages(tmp_path / "big_t.tif", specs,
                                   bigtiff=True).read_bytes() == p.read_bytes()
    j, t = _both(p)
    assert t.mpp == j.mpp == 0.3 and t.level_dimensions == j.level_dimensions
    _regions_equal(j, t, [((100, 100), 0, (300, 200)), ((0, 0), 1, (384, 256))])


@pytest.mark.parametrize("compression,quality", [(1, 90), (8, 90), (7, 50), (7, 75),
                                                 (7, 90), (7, 95)])
def test_writer_bytes_equal_jax(tmp_path, tissue, compression, quality):
    levels = [tissue, tissue[::2, ::2]]
    a = j_write_tiled(tmp_path / "a.svs", levels, 256, compression, quality, "MPP = 0.25")
    b = twrite.write_tiled_tiff(tmp_path / "b.svs", levels, 256, compression, quality,
                                "MPP = 0.25")
    assert a.read_bytes() == b.read_bytes()
    a = j_write_striped(tmp_path / "a.tif", levels, 48, compression, quality)
    b = twrite.write_striped_tiff(tmp_path / "b.tif", levels, 48, compression, quality)
    assert a.read_bytes() == b.read_bytes()


def test_writer_rejects_what_jax_rejects(tmp_path):
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="unsupported write compression"):
        twrite.write_tiled_tiff(tmp_path / "bad.tif", [img], tile_size=64, compression=5)
    with pytest.raises(ValueError, match="striped"):
        twrite.write_striped_tiff(tmp_path / "bad.tif", [img], compression=33003)


def test_codecs_match_jax():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
    diff = img.astype(np.int16).copy()
    diff[:, 1:] -= img[:, :-1].astype(np.int16)
    raw = (diff % 256).astype(np.uint8).tobytes()
    np.testing.assert_array_equal(ttiff._raw_to_rgb(raw, 32, 48, 3, predictor=2), img)
    np.testing.assert_array_equal(ttiff._raw_to_rgb(raw, 32, 48, 3, predictor=2),
                                  jtiff._raw_to_rgb(raw, 32, 48, 3, predictor=2))
    gray = ttiff._raw_to_rgb(img[..., 0].tobytes(), 32, 48, 1)
    np.testing.assert_array_equal(gray, jtiff._raw_to_rgb(img[..., 0].tobytes(), 32, 48, 1))
    for fn in ("_raw_to_rgb",):
        with pytest.raises(ValueError):
            getattr(ttiff, fn)(raw[:100], 32, 48, 3)
    for seed in range(20):
        data = np.random.default_rng(seed).integers(0, 256, 300, dtype=np.uint8).tobytes()
        assert ttiff._packbits_decode(data) == jtiff._packbits_decode(data)
        got = ref = None
        try:
            ref = jtiff._lzw_decode(data)
        except Exception as e:  # noqa: BLE001
            ref = type(e)
        try:
            got = ttiff._lzw_decode(data)
        except Exception as e:  # noqa: BLE001
            got = type(e)
        assert got == ref


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, early change), enough for a test page."""
    table = {bytes([i]): i for i in range(256)}
    out, bits, nbits, width, w = bytearray(), 0, 0, 9, b""

    def emit(code):
        nonlocal bits, nbits
        bits = (bits << width) | code
        nbits += width
        while nbits >= 8:
            out.append((bits >> (nbits - 8)) & 255)
            nbits -= 8

    emit(256)
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = len(table) + 2
        w = bytes([b])
        if len(table) + 2 >= (1 << width) and width < 12:
            width += 1
        if len(table) + 2 >= 4094:
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            width = 9
    emit(table[w])
    emit(257)
    if nbits:
        out.append((bits << (8 - nbits)) & 255)
    return bytes(out)


def test_lzw_pages_match_jax():
    rng = np.random.default_rng(2)
    img = np.kron(rng.integers(0, 255, (8, 8, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
    enc = _lzw_encode(img.tobytes())
    assert jtiff._lzw_decode(enc) == img.tobytes()
    assert ttiff._lzw_decode(enc) == img.tobytes()


def _smooth_jpeg_slide(tmp_path, name="planar.svs", seed=11):
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(40, 220, size=(8, 8, 3), dtype=np.uint8),
                   np.ones((64, 64, 1), np.uint8))
    return j_write_tiled(tmp_path / name, [base], tile_size=256, compression=7)


def test_planar_regions_match_jax(tmp_path):
    p = _smooth_jpeg_slide(tmp_path)
    j, t = _both(p)
    assert t.supports_planar(0) and j.supports_planar(0)
    for (x0, y0), (w, h) in [((0, 0), (512, 512)), ((100, 100), (300, 200)),
                             ((224, 256), (224, 224)), ((400, 400), (200, 200))]:
        ry, rc = j.read_region_planar((x0, y0), 0, (w, h))
        gy, gc = t.read_region_planar((x0, y0), 0, (w, h))
        np.testing.assert_array_equal(gy, ry)
        np.testing.assert_array_equal(gc, rc)
    assert t.read_region_planar((101, 100), 0, (224, 224)) is None
    assert t.read_region_planar((100, 100), 0, (225, 224)) is None
    img = np.full((300, 300, 3), 90, np.uint8)
    z = TiffTileSlide(j_write_tiled(tmp_path / "z.tif", [img], tile_size=256, compression=8))
    assert not z.supports_planar(0) and z.read_region_planar((0, 0), 0, (256, 256)) is None


def test_planar_prefetch_failures_and_budget(tmp_path):
    p = _smooth_jpeg_slide(tmp_path, seed=15)
    t = TiffTileSlide(p)
    assert t.prefetch_regions_planar(np.array([[100, 100]]), 0, (300, 300)) == 4
    assert t.prefetch_regions_planar(np.array([[100, 100]]), 0, (300, 300)) == 0
    # failures are memoized: a tile the planar decode refuses is not decoded again
    t = TiffTileSlide(p)
    calls = []

    def refuse(*a, **k):
        calls.append(1)
        return None

    t._native.decode_jpeg_batch_planar = refuse
    assert t.read_region_planar((0, 0), 0, (224, 224)) is None
    n = len(calls)
    assert n >= 1 and t.read_region_planar((0, 0), 0, (224, 224)) is None
    assert len(calls) == n
    # RGB and planar entries share one budget
    t = TiffTileSlide(p, cache_tiles=6)
    t.prefetch_regions(np.array([[0, 0]]), 0, (512, 512))
    t.prefetch_regions_planar(np.array([[0, 0]]), 0, (512, 512))
    assert len(t._cache) <= 6 and {k[0] for k in t._cache} == {"rgb", "p"}


def test_strip_cache_byte_budget(tmp_path):
    img = np.random.default_rng(2).integers(0, 255, (384, 1024, 3), np.uint8)
    t = TiffTileSlide(j_write_striped(tmp_path / "b.tif", [img], rows_per_strip=128),
                      cache_tiles=3)
    np.testing.assert_array_equal(t.read_region((0, 0), 0, (1024, 384)), img)
    assert t._cache_bytes <= t._cache_bytes_cap and len(t._cache) <= 1
    st = TiffTileSlide(j_write_tiled(tmp_path / "t.tif", [img], tile_size=256), cache_tiles=8)
    st.read_region((0, 0), 0, (1024, 384))
    assert len(st._cache) == 8 and st._cache_bytes <= st._cache_bytes_cap


def test_refused_tiles_go_through_pil_counted(tmp_path, tissue, monkeypatch):
    """Progressive tiles: the port's decoder refuses them, PIL decodes them
    to the pixels the JAX reader gives (libjpeg), and the reader counts
    them by reason."""
    import io

    from PIL import Image

    def progressive(rgb, quality=90):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(rgb)).save(buf, "JPEG", quality=quality,
                                                        subsampling=2, progressive=True)
        return buf.getvalue()

    monkeypatch.setattr(twrite, "encode_jpeg", progressive)
    p = twrite.write_tiled_tiff(tmp_path / "prog.svs", [tissue[:512, :512]], 256, 7)
    j, t = _both(p)
    _regions_equal(j, t, [((0, 0), 0, (512, 512))])
    assert t.decoder_refusals == 4 and dict(t.decoder_refusal_reasons) == {"progressive": 4}
    np.testing.assert_array_equal(t.read_tiles_batch(0, np.arange(4)),
                                  j.read_tiles_batch(0, np.arange(4)))
    assert t.decoder_refusals == 8
    assert not t.supports_planar(0)


def test_refusal_count_under_concurrent_reads(tmp_path, tissue, monkeypatch):
    """Threads reading one slide (as the prefetch pools do) lose no
    refusal count: it equals the PIL decodes made, and every read is
    right."""
    import io
    import sys
    import threading

    from PIL import Image

    def progressive(rgb, quality=90):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(rgb)).save(buf, "JPEG", quality=quality,
                                                        progressive=True)
        return buf.getvalue()

    monkeypatch.setattr(twrite, "encode_jpeg", progressive)
    p = twrite.write_tiled_tiff(tmp_path / "prog.svs", [tissue[:512, :512]], 256, 7)
    ref = JSlide(p).read_region((0, 0), 0, (512, 512))
    t = TiffTileSlide(p, cache_tiles=1)  # one cached tile: most reads decode again
    made, lock = [0], threading.Lock()
    real = ttiff._decode_jpeg_pil

    def counted(*a):
        with lock:
            made[0] += 1
        return real(*a)

    monkeypatch.setattr(ttiff, "_decode_jpeg_pil", counted)
    wrong = []

    def work(k):
        for j in range(6):
            x, y = 128 * ((k + j) % 3), 128 * ((k * j) % 3)
            if not np.array_equal(t.read_region((x, y), 0, (256, 256)),
                                  ref[y: y + 256, x: x + 256]):
                wrong.append((k, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not wrong
    assert made[0] > 16 and t.decoder_refusals == made[0]
    assert dict(t.decoder_refusal_reasons) == {"progressive": made[0]}


@pytest.mark.parametrize("case", ["empty", "bad_magic", "truncated_header",
                                  "huge_ifd_count", "ifd_loop", "oversize_tag"])
def test_malformed_headers_raise_as_jax(tmp_path, case):
    p = tmp_path / f"{case}.svs"
    p.write_bytes({
        "empty": b"",
        "bad_magic": b"II\x99\x00" + b"\x00" * 64,
        "truncated_header": b"II*\x00\x08\x00\x00",
        "huge_ifd_count": b"II*\x00\x08\x00\x00\x00" + struct.pack("<H", 0xFFFF),
        "ifd_loop": b"II*\x00\x08\x00\x00\x00" + struct.pack("<H", 0) + struct.pack("<I", 8),
        "oversize_tag": b"II*\x00\x08\x00\x00\x00" + struct.pack("<H", 1)
        + struct.pack("<HHI", 256, 4, 1 << 28) + struct.pack("<I", 64) + struct.pack("<I", 0),
    }[case])
    with pytest.raises(Exception) as ref:
        JSlide(p)
    with pytest.raises(Exception) as got:
        TiffTileSlide(p)
    assert type(got.value) is type(ref.value)
    assert not isinstance(got.value, (MemoryError, RecursionError, SystemError))


def test_header_fuzz_fails_closed_like_jax(tmp_path):
    """A seeded corruption sweep over a JPEG SVS and a striped deflate TIFF:
    every mutated file opens and reads as the JAX reader's does, or raises
    a clean exception where it raises (never a hang or a crash)."""
    rng = np.random.default_rng(1234)
    img = np.kron(rng.integers(40, 220, (4, 4, 3), np.uint8), np.ones((64, 64, 1), np.uint8))
    srcs = [j_write_tiled(tmp_path / "base.svs", [img], tile_size=128, compression=7),
            j_write_pages(tmp_path / "base.tif", [{"img": img, "layout": "striped",
                                                   "rows_per_strip": 48}])]
    outcomes = {"equal": 0, "both_raise": 0, "port_raises": 0}
    for src in srcs:
        data = bytearray(src.read_bytes())
        n = len(data)
        for k in range(60):
            buf = bytearray(data)
            if k % 3 == 0:
                buf = buf[: int(rng.integers(0, n))]
            else:
                lo, hi = [(0, min(1024, n)), (max(0, n - 1024), n)][k % 2]
                for pos in rng.integers(lo, hi, size=int(rng.integers(1, 4))):
                    buf[pos] ^= int(rng.integers(1, 256))
            p = tmp_path / f"fuzz{src.suffix}"
            p.write_bytes(bytes(buf))
            res = []
            for cls in (JSlide, TiffTileSlide):
                try:
                    s = cls(p)
                    res.append((s.read_region((0, 0), 0, (96, 96)),
                                s.read_tiles_batch(0, np.array([0]))))
                except Exception as e:  # noqa: BLE001
                    assert not isinstance(e, (MemoryError, RecursionError, SystemError))
                    res.append(None)
            if res[0] is not None and res[1] is not None:
                for a, b in zip(res[0], res[1]):
                    np.testing.assert_array_equal(b, a)
                outcomes["equal"] += 1
            elif res[1] is None:
                outcomes["both_raise" if res[0] is None else "port_raises"] += 1
            else:
                raise AssertionError(f"the port read a file the JAX reader rejects ({k})")
    assert outcomes["equal"] > 20, outcomes


def test_open_slide_matches_jax(tmp_path, tissue):
    p = j_write_tiled(tmp_path / "x.tif", [tissue[:300, :300]], tile_size=256, compression=8)
    s = open_slide(p)
    assert isinstance(s, TiffTileSlide)
    np.testing.assert_array_equal(s.read_region((0, 0), 0, (300, 300)), tissue[:300, :300])
    from PIL import Image

    Image.fromarray(tissue[:200, :160]).save(tmp_path / "x.png")
    Image.fromarray(tissue[:200, :160]).save(tmp_path / "x.jpg", quality=90)
    (tmp_path / "junk.svs").write_bytes(b"not a tiff")
    for name in ("x.png", "x.jpg"):
        a, b = open_slide(tmp_path / name), j_open_slide(tmp_path / name)
        np.testing.assert_array_equal(a.read_region((0, 0), 0, (160, 200)),
                                      b.read_region((0, 0), 0, (160, 200)))
    with pytest.raises(ValueError, match="cannot open slide"):
        open_slide(tmp_path / "junk.svs")
    synth = synthetic_wsi(256, 256, seed=1)
    npz = synth.save(tmp_path / "fixture")
    np.testing.assert_array_equal(open_slide(npz).read_region((0, 0), 0, (64, 64)),
                                  j_open_slide(npz).read_region((0, 0), 0, (64, 64)))


def test_open_slide_npy_matches_jax(tmp_path):
    rgb = np.random.default_rng(1).integers(0, 255, (32, 40, 3), np.uint8)
    arrays = {"u8": rgb, "gray": rgb[..., 0], "unit": rgb.astype(np.float64) / 255.0,
              "f255": rgb.astype(np.float32), "i16": rgb.astype(np.int16),
              "neg": rgb.astype(np.float32) - 300.0, "big": rgb.astype(np.uint16) + 300,
              "bad": np.zeros((4, 4, 4, 4), np.uint8)}
    for name, arr in arrays.items():
        p = tmp_path / f"{name}.npy"
        np.save(p, arr)
        try:
            ref = j_open_slide(p).read_region((0, 0), 0, (40, 32))
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                open_slide(p)
            assert str(got.value) == str(e)
            continue
        np.testing.assert_array_equal(open_slide(p).read_region((0, 0), 0, (40, 32)), ref)
