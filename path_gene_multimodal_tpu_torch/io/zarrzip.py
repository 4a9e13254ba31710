"""Minimal zarr-v2 ZipStore writer/reader (stdlib only: zipfile + zlib + json).

A copy of the JAX package's ``io/zarrzip.py``. The reference's nuclei
consumers open the instance map as a zarr zip (``zarr.open("pinst_pp.zip")``
in ``aggregated_hovernet_run.py:163-166`` and ``hovernet_plotting.py:44-73``).
The zip format is a ZIP archive holding a ``.zarray`` JSON plus raw chunk
blobs, so this module writes the artifact without zarr. Chunks are
zlib-compressed (``numcodecs.Zlib``, decodable by any zarr install) or raw
(``compressor: null``).

zarr v2 specifics honored here: C-order chunks stored FULL-SIZE (edge
chunks padded with ``fill_value``), chunk keys ``"i.j.k"`` at the store
root, ``.zarray`` metadata with dtype in numpy byte-order notation.
"""

from __future__ import annotations

import itertools
import json
import zipfile
import zlib
from pathlib import Path

import numpy as np

_DEFAULT_CHUNK = 2048


def _default_chunks(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Unit-size leading axes, ≤2048 trailing 2-D plane (the layout zarr
    picks for (1, H, W) instance maps)."""
    out = []
    for i, s in enumerate(shape):
        if i < len(shape) - 2:
            out.append(1)
        else:
            out.append(min(s, _DEFAULT_CHUNK))
    return tuple(out)


def write_zarr_zip(
    path: str | Path,
    arr: np.ndarray,
    chunks: tuple[int, ...] | None = None,
    compress_level: int = 1,
) -> Path:
    """Write ``arr`` as a single zarr-v2 array in a zip store.

    ``compress_level`` 0 writes raw chunks (``compressor: null``);
    1-9 writes zlib chunks (``{"id": "zlib", "level": N}``).
    """
    path = Path(path)
    arr = np.ascontiguousarray(arr)
    if chunks is None:
        chunks = _default_chunks(arr.shape)
    if len(chunks) != arr.ndim:
        raise ValueError(f"chunks {chunks} rank != array rank {arr.ndim}")
    fill_value: float | int = 0 if arr.dtype.kind in "iub" else 0.0
    meta = {
        "chunks": list(chunks),
        "compressor": (
            None if compress_level == 0 else {"id": "zlib", "level": compress_level}
        ),
        "dtype": arr.dtype.str,
        "fill_value": fill_value,
        "filters": None,
        "order": "C",
        "shape": list(arr.shape),
        "zarr_format": 2,
    }
    n_chunks = [-(-s // c) for s, c in zip(arr.shape, chunks)]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        zf.writestr(".zarray", json.dumps(meta, indent=4))
        for idx in itertools.product(*(range(n) for n in n_chunks)):
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, arr.shape)
            )
            block = arr[sel]
            if block.shape != tuple(chunks):  # edge chunk: pad to full size
                full = np.full(chunks, fill_value, arr.dtype)
                full[tuple(slice(0, e) for e in block.shape)] = block
                block = full
            raw = np.ascontiguousarray(block).tobytes()
            if compress_level:
                raw = zlib.compress(raw, compress_level)
            zf.writestr(".".join(map(str, idx)), raw)
    return path


def read_zarr_zip(path: str | Path) -> np.ndarray:
    """Read a single-array zarr-v2 zip store (null or zlib compressor)."""
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        meta_key = ".zarray"
        if meta_key not in names:  # array nested one level down
            nested = [n for n in names if n.endswith("/.zarray")]
            if not nested:
                raise ValueError(f"{path}: no .zarray in zip store")
            meta_key = nested[0]
        prefix = meta_key[: -len(".zarray")]
        meta = json.loads(zf.read(meta_key))
        if meta.get("zarr_format") != 2:
            raise ValueError(f"unsupported zarr_format {meta.get('zarr_format')}")
        if meta.get("filters"):
            raise ValueError("zarr filters are not supported")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") not in ("zlib", "gzip"):
            raise ValueError(f"unsupported compressor {comp}")
        dtype = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        chunks = tuple(meta["chunks"])
        if meta.get("order", "C") != "C":
            raise ValueError("only C-order zarr arrays are supported")
        out = np.full(shape, meta.get("fill_value") or 0, dtype)
        n_chunks = [-(-s // c) for s, c in zip(shape, chunks)]
        for idx in itertools.product(*(range(n) for n in n_chunks)):
            key = prefix + ".".join(map(str, idx))
            if key not in names:
                continue  # missing chunk = fill_value
            raw = zf.read(key)
            if comp is not None:
                # wbits=32+15 auto-detects zlib vs gzip headers — numcodecs
                # GZip writes gzip-format streams that plain decompress rejects
                raw = zlib.decompress(raw, 32 + 15)
            block = np.frombuffer(raw, dtype).reshape(chunks)
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            out[sel] = block[tuple(slice(0, sl.stop - sl.start) for sl in sel)]
    return out
