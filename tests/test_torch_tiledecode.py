"""The port's tile decoder (``csrc/tiledecode.cpp`` through
``io/native.py``) against the JAX package's ``NativeTileDecoder``
(libjpeg-turbo), on the CPU: every output form (fancy RGB, nearest RGB,
raw 4:2:0 planes with their per-tile ``ok`` flags) equal bit for bit, over
qualities, samplings, restart intervals, optimized Huffman tables, tables
plus abbreviated streams, odd and undersized tiles, truncated tiles and
headers with huge dimensions; a sweep of corrupt streams (it never
accepts what libjpeg rejects); the streams it refuses, with their
reasons; deflate; and the build (g++, no libjpeg, temp file then replace,
rebuilt when the source is newer, a failure raises)."""

import io
import subprocess

import numpy as np
import pytest
from PIL import Image

from path_gene_multimodal_tpu.io.native import NativeTileDecoder as JDecoder
from path_gene_multimodal_tpu_torch.io import native
from path_gene_multimodal_tpu_torch.io.native import NativeTileDecoder

SAMPLING = {"420": 2, "422": 1, "444": 0}


@pytest.fixture(scope="module")
def decoders():
    return JDecoder(), NativeTileDecoder()


def _image(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour fields with noise and sharp blocks (chroma edges)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(yy / 7.0), 128 + 90 * np.cos(xx / 5.0),
                     128 + 60 * np.sin((xx + yy) / 9.0)], -1)
    base += rng.normal(0, 14, base.shape)
    base[h // 3: h // 2, w // 4: w // 2] = rng.integers(0, 256, 3)
    return np.clip(base, 0, 255).astype(np.uint8)


def _jpeg(img: np.ndarray, quality: int = 90, sampling: str = "420", **kw) -> bytes:
    buf = io.BytesIO()
    if img.ndim == 2:
        Image.fromarray(img, "L").save(buf, "JPEG", quality=quality, **kw)
    else:
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=SAMPLING[sampling], **kw)
    return buf.getvalue()


def _assert_forms_equal(decoders, blobs, th, tw, tables=None, planar_ok=None):
    """Every form equal to the JAX decoder's; returns the port's planar ok
    flags."""
    jd, td = decoders
    for name in ("decode_jpeg_batch", "decode_jpeg_batch_nearest"):
        ref = getattr(jd, name)(blobs, th, tw, tables)
        got = getattr(td, name)(blobs, th, tw, tables)
        assert ref is not None and got is not None, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    ry, rc, rok = jd.decode_jpeg_batch_planar(blobs, th, tw, tables, return_ok=True)
    gy, gc, gok = td.decode_jpeg_batch_planar(blobs, th, tw, tables, return_ok=True)
    np.testing.assert_array_equal(gok, rok)
    np.testing.assert_array_equal(gy[gok], ry[rok])
    np.testing.assert_array_equal(gc[gok], rc[rok])
    if planar_ok is not None:
        assert gok.tolist() == planar_ok
    assert (td.decode_jpeg_batch_planar(blobs, th, tw, tables) is None) == (not gok.all())
    return gok


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("quality", [50, 75, 90, 95])
def test_forms_match_libjpeg(decoders, quality, sampling):
    img = _image(64, 96, seed=quality)
    blobs = [_jpeg(img[..., 1] if sampling == "gray" else img, quality,
                   "420" if sampling == "gray" else sampling),
             _jpeg(_image(64, 96, seed=quality + 1)[..., 0] if sampling == "gray"
                   else _image(64, 96, seed=quality + 1), quality,
                   "420" if sampling == "gray" else sampling)]
    ok = _assert_forms_equal(decoders, blobs, 64, 96)
    assert ok.all() == (sampling == "420")


def test_restart_interval_and_optimized_tables(decoders):
    import cv2

    img = _image(80, 72, seed=3)
    blobs = []
    for rst in (1, 3, 7):
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 85,
                                                        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        assert ok and b"\xff\xdd" in enc.tobytes()
        blobs.append(enc.tobytes())
    blobs.append(_jpeg(img, 85, optimize=True))
    _assert_forms_equal(decoders, blobs, 80, 72, planar_ok=[True] * 4)


def _split_tables(blob: bytes) -> tuple[bytes, bytes]:
    """(tables-only stream, abbreviated stream): the DQT/DHT segments moved
    into SOI ... EOI, as TIFF JPEGTables stores them."""
    sos = blob.find(b"\xff\xda")
    tables, rest, i = b"\xff\xd8", b"\xff\xd8", 2
    while i < sos:
        seg = blob[i: i + 2 + ((blob[i + 2] << 8) | blob[i + 3])]
        if seg[1] in (0xDB, 0xC4):
            tables += seg
        else:
            rest += seg
        i += len(seg)
    return tables + b"\xff\xd9", rest + blob[sos:]


def test_tables_and_abbreviated_streams(decoders):
    blobs, shared = [], None
    for seed in range(3):
        tables, abbrev = _split_tables(_jpeg(_image(64, 64, seed), 90))
        assert b"\xff\xdb" not in abbrev and b"\xff\xc4" not in abbrev
        shared = shared or tables
        assert tables == shared  # one quality: one set of tables
        blobs.append(abbrev)
    _assert_forms_equal(decoders, blobs, 64, 64, tables=shared, planar_ok=[True] * 3)
    # without the tables the abbreviated stream has none: refused
    _, status = decoders[1].decode_jpeg_status(blobs, 64, 64)
    assert [native.REFUSALS[s] for s in status] == ["missing_table"] * 3


@pytest.mark.parametrize("hw", [(1, 1), (2, 5), (5, 3), (17, 9), (33, 70), (200, 201),
                                (200, 200)])
def test_odd_and_undersized_tiles(decoders, hw):
    """Sizes that crop inside an MCU, chroma planes one or two samples
    wide (where libjpeg's fancy upsampling stands down), and tiles smaller
    than their slot (white padding); the planar form refuses odd sizes."""
    h, w = hw
    blob = _jpeg(_image(h, w, seed=h * 1000 + w), 90)
    for th, tw in ((h, w), (max(h, 8) + 7, max(w, 8) + 5), (max(1, h - 1), max(1, w - 2))):
        _assert_forms_equal(decoders, [blob], th, tw,
                            planar_ok=[h % 2 == 0 and w % 2 == 0])
    big = decoders[1].decode_jpeg_batch([blob], h + 40, w + 40)
    assert (big[0, h:] == 255).all() and (big[0, :, w:] == 255).all()


def test_truncated_tile_matches_libjpeg_zero_fill(decoders):
    """libjpeg decodes a premature end as zero bits and reports success; the
    port does the same, so the planar route serves a truncated tile as the
    JAX package's does (the chunk does not fall back to RGB)."""
    jd, td = decoders
    img = _image(64, 96, seed=8)
    blob = _jpeg(img, 90)
    for cut in (len(blob) // 2, len(blob) - 40, len(blob) - 3):
        _assert_forms_equal(decoders, [blob[:cut]], 64, 96, planar_ok=[True])
    half = td.decode_jpeg_batch([blob[: len(blob) // 2]], 64, 96)[0]
    full = td.decode_jpeg_batch([blob], 64, 96)[0]
    assert not np.array_equal(half, full)  # the fill really changed the tile
    # with restart markers too
    import cv2

    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    _assert_forms_equal(decoders, [enc.tobytes()[: len(enc) * 2 // 3]], 64, 96)
    # cut inside the headers: refused (libjpeg stops with an error there)
    _, status = td.decode_jpeg_status([blob[:100]], 64, 96)
    assert native.REFUSALS[int(status[0])] == "corrupt"


def _patch_segment(blob: bytes, marker: int, fn) -> bytes:
    """``fn(bytearray, start)`` edits the first segment with ``marker``
    (``start`` = index of its 0xFF)."""
    buf, i = bytearray(blob), 2
    while i + 4 <= len(buf):
        if buf[i + 1] == marker:
            fn(buf, i)
            return bytes(buf)
        i += 2 + ((buf[i + 2] << 8) | buf[i + 3])
    raise AssertionError(f"no marker {marker:#x}")


def _patch_sof_dims(blob: bytes, h: int, w: int) -> bytes:
    return _patch_segment(blob, 0xC0, lambda b, i: b.__setitem__(
        slice(i + 5, i + 9), bytes([h >> 8, h & 255, w >> 8, w & 255])))


def test_huge_header_dims_fail_closed(decoders):
    jd, td = decoders
    good = _jpeg(np.full((224, 224, 3), 180, np.uint8))
    corrupt = _patch_sof_dims(good, 65500, 65500)
    assert jd.decode_jpeg_batch([corrupt], 224, 224) is None
    assert td.decode_jpeg_batch([corrupt], 224, 224) is None
    _, status = td.decode_jpeg_status([corrupt], 224, 224)
    assert native.REFUSALS[int(status[0])] == "dimensions"
    y, _, ok = td.decode_jpeg_batch_planar([good, corrupt], 224, 224, return_ok=True)
    assert ok.tolist() == [True, False] and int(y[0].min()) > 0
    # a mild overstatement stays within the 2x-tile crop tolerance and
    # decodes with zero fill, as libjpeg does
    _assert_forms_equal(decoders, [_patch_sof_dims(good, 300, 300)], 224, 224,
                        planar_ok=[True])


def test_progressive_refused_and_counted(decoders):
    """The port refuses what it does not decode; libjpeg decodes it."""
    jd, td = decoders
    img = _image(64, 64, seed=4)
    prog = _jpeg(img, 90, progressive=True)
    assert jd.decode_jpeg_batch([prog], 64, 64) is not None
    assert td.decode_jpeg_batch([prog], 64, 64) is None
    (rgb,), status = td.decode_jpeg_status([_jpeg(img), prog], 64, 64)
    assert [int(s) for s in status] == [0, 2] and native.REFUSALS[2] == "progressive"
    np.testing.assert_array_equal(rgb[0], jd.decode_jpeg_batch([_jpeg(img)], 64, 64)[0])
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG", quality=90)
    _, status = td.decode_jpeg_status([cmyk.getvalue()], 64, 64)
    assert native.REFUSALS[int(status[0])] == "color"


@pytest.mark.parametrize("edit,reason", [
    (lambda b, i: b.__setitem__(i + 1, 0xC9), "arithmetic"),       # SOF9
    (lambda b, i: b.__setitem__(i + 1, 0xC3), "unsupported_sof"),  # lossless
    (lambda b, i: b.__setitem__(i + 4, 12), "precision"),          # 12-bit samples
    (lambda b, i: b.__setitem__(i + 11, 0x12), "sampling"),        # Y 1x2: 4:4:0
    (lambda b, i: b.__setitem__(i + 11, 0x31), "sampling"),        # Y 3x1
])
def test_refusal_reasons(decoders, edit, reason):
    """Frames the decoder does not take are refused with their reason, never
    decoded by guess; libjpeg (lossless, 12-bit: an error in this build;
    arithmetic: its own decoder) does not decode them as baseline either."""
    jd, td = decoders
    blob = _patch_segment(_jpeg(_image(32, 32, seed=9)), 0xC0, edit)
    _, status = td.decode_jpeg_status([blob], 32, 32)
    assert native.REFUSALS[int(status[0])] == reason
    assert td.decode_jpeg_batch([blob], 32, 32) is None


def test_corrupt_streams_fail_closed(decoders):
    """A seeded sweep of byte flips, inserted markers and cuts: where the
    port's decoder accepts a stream, libjpeg accepts it too and the pixels
    are equal; where libjpeg rejects one, the port refuses it."""
    import cv2

    jd, td = decoders
    rng = np.random.default_rng(77)
    seen = {"equal": 0, "both_refuse": 0, "port_refuses": 0}
    for k in range(240):
        img = _image(40, 56, seed=k % 7)
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.choice([30, 90]))]
        if k % 3 == 1:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]
        blob = bytearray(cv2.imencode(".jpg", img, params)[1].tobytes())
        sos = bytes(blob).find(b"\xff\xda")
        if k % 4 == 0:  # header bytes
            for pos in rng.integers(2, sos + 10, size=int(rng.integers(1, 3))):
                blob[pos] = int(rng.integers(0, 256))
        elif k % 4 == 1:  # anywhere
            for pos in rng.integers(0, len(blob), size=int(rng.integers(1, 4))):
                blob[pos] = int(rng.integers(0, 256))
        elif k % 4 == 2:  # a marker inside the scan
            pos = int(rng.integers(sos + 14, len(blob) - 2))
            blob[pos:pos] = bytes([0xFF, int(rng.integers(1, 256))])
        else:
            blob = blob[: int(rng.integers(0, len(blob)))]
        blob = bytes(blob)
        for form in ("fancy", "planar"):
            ref = (jd.decode_jpeg_batch([blob], 40, 56) if form == "fancy"
                   else jd.decode_jpeg_batch_planar([blob], 40, 56))
            outs, status = td.decode_jpeg_status([blob], 40, 56, form=form)
            if status[0]:
                seen["both_refuse" if ref is None else "port_refuses"] += 1
                continue
            assert ref is not None, (k, form)  # never accepts what libjpeg rejects
            for got, want in zip(outs, ref if isinstance(ref, tuple) else (ref,)):
                np.testing.assert_array_equal(got, want, err_msg=f"{k} {form}")
            seen["equal"] += 1
    assert seen["equal"] > 200 and seen["both_refuse"] > 50, seen


def test_fancy_equals_pil(decoders):
    """The fancy form is what PIL (its own libjpeg-turbo) decodes."""
    blobs = [_jpeg(_image(128, 128, seed=s), q) for s, q in ((1, 90), (2, 75))]
    got = decoders[1].decode_jpeg_batch(blobs, 128, 128)
    for g, b in zip(got, blobs):
        np.testing.assert_array_equal(g, np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))


def test_threads_agree(decoders):
    blobs = [_jpeg(_image(96, 96, seed=s), 90) for s in range(12)]
    one = NativeTileDecoder(num_threads=1)
    for form in ("fancy", "planar"):
        a, sa = one.decode_jpeg_status(blobs, 96, 96, form=form)
        b, sb = decoders[1].decode_jpeg_status(blobs, 96, 96, form=form)
        assert not sa.any() and not sb.any()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_deflate_matches(decoders):
    import zlib

    rng = np.random.default_rng(3)
    tiles = [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(4)]
    blobs = [zlib.compress(t.tobytes()) for t in tiles]
    got = decoders[1].decode_deflate_batch(blobs, 64, 64)
    np.testing.assert_array_equal(got, decoders[0].decode_deflate_batch(blobs, 64, 64))
    np.testing.assert_array_equal(got, np.stack(tiles))
    short = decoders[1].decode_deflate_batch([zlib.compress(tiles[0][:10].tobytes())], 64, 64)
    assert (short[0, 10:] == 255).all()
    assert decoders[1].decode_deflate_batch([b"not deflate"], 64, 64) is None


def test_library_links_no_libjpeg():
    lib = native.build_native()
    assert lib == native.LIB_PATH and lib.parent.name == "native"
    cmd = native.build_command(lib)
    assert "-ljpeg" not in cmd and "-march=native" not in cmd
    assert cmd[-2:] == ["-lz", "-lpthread"]
    assert b"libjpeg" not in lib.read_bytes()  # no NEEDED entry names it


@pytest.fixture
def temp_build(tmp_path, monkeypatch):
    """The build pointed at a copy of the source in ``tmp_path``."""
    src = tmp_path / "tiledecode.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "libtiledecode.so")
    return src


def test_build_temp_then_replace_and_rebuild_when_stale(temp_build, monkeypatch):
    import os

    seen = []
    real_run = subprocess.run

    def spy(cmd, **kw):
        seen.append(cmd[cmd.index("-o") + 1])
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    lib = native.build_native()
    assert lib.exists() and len(seen) == 1
    assert seen[0].endswith(".so.tmp") and seen[0] != str(lib)
    assert not list(lib.parent.glob("*.so.tmp"))  # the temp file was replaced
    native.build_native()
    assert len(seen) == 1  # fresh: no rebuild
    t = lib.stat().st_mtime + 10
    os.utime(temp_build, (t, t))
    native.build_native()
    assert len(seen) == 2  # the source is newer: rebuilt


def test_build_failure_raises(temp_build):
    temp_build.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_native()
    assert not native.LIB_PATH.exists()
