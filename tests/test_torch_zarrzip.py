"""The port's zarr-v2 zip store (``io/zarrzip.py``) against the JAX
package's: the same round trips, and each package reads the other's zips,
whose members are byte-identical."""

import zipfile

import numpy as np
import pytest

from path_gene_multimodal_tpu.io import zarrzip as jz
from path_gene_multimodal_tpu_torch.io import zarrzip as tz

CASES = [
    ((1, 300, 500), (1, 128, 128), np.uint32),  # pinst_pp layout, edge chunks
    ((7, 9), (4, 4), np.float32),
    ((5,), (2,), np.int64),
    ((1, 2048, 2048), None, np.uint32),  # exactly one default chunk
    ((3, 3), (8, 8), np.uint8),  # chunk larger than array
]


def _array(shape, dtype):
    rng = np.random.default_rng(0)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 1000, size=shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("shape,chunks,dtype", CASES)
@pytest.mark.parametrize("level", [1, 0])
def test_roundtrip_and_cross_read(tmp_path, shape, chunks, dtype, level):
    arr = _array(shape, dtype)
    tp = tz.write_zarr_zip(tmp_path / "t.zip", arr, chunks=chunks, compress_level=level)
    jp = jz.write_zarr_zip(tmp_path / "j.zip", arr, chunks=chunks, compress_level=level)
    for read in (tz.read_zarr_zip, jz.read_zarr_zip):
        for p in (tp, jp):
            back = read(p)
            assert back.dtype == arr.dtype and back.shape == arr.shape
            np.testing.assert_array_equal(back, arr)
    # the same members (.zarray, chunk keys; no .zattrs in either), byte for byte
    tm, jm = _members(tp), _members(jp)
    assert sorted(tm) == sorted(jm) and ".zarray" in tm and ".zattrs" not in tm
    assert tm == jm


def test_default_chunks_match_jax():
    for shape in [(1, 300, 500), (1, 5000, 3000), (7, 9), (5,), (2, 3, 4096, 10)]:
        assert tz._default_chunks(shape) == jz._default_chunks(shape)


def test_read_gzip_and_nested_store(tmp_path):
    """numcodecs.GZip streams and an array one level down in the store, as
    the JAX reader takes them."""
    import gzip
    import json

    arr = np.arange(12, dtype=np.uint32).reshape(3, 4)
    meta = {"zarr_format": 2, "shape": [3, 4], "chunks": [3, 4], "dtype": arr.dtype.str,
            "order": "C", "fill_value": 0, "compressor": {"id": "gzip", "level": 5},
            "filters": None}
    p = tmp_path / "g.zip"
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("inst/.zarray", json.dumps(meta))
        zf.writestr("inst/0.0", gzip.compress(arr.tobytes()))
    np.testing.assert_array_equal(tz.read_zarr_zip(p), jz.read_zarr_zip(p))
    np.testing.assert_array_equal(tz.read_zarr_zip(p), arr)
