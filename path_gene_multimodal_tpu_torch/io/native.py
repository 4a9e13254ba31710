"""The port's host tile decoder: ``csrc/tiledecode.cpp`` built with g++ and
loaded with ctypes.

``csrc/tiledecode.cpp`` holds its own baseline JPEG decoder (equal to
libjpeg's output bit for bit on the streams it accepts) and links only zlib
and pthread, so it builds where no libjpeg is installed. It is compiled at
first use into ``build/native/libtiledecode.so`` beside the package (a
directory git ignores) and rebuilt when the source is newer. The compile
goes to a temporary file that is ``os.replace``d into place under a file
lock, so concurrent processes neither race nor map a half-written library.
No ``-march=native``: the library runs on any x86-64 host it is copied to.
A failed build or load raises; nothing falls back.

``NativeTileDecoder`` keeps the methods and signatures of the JAX package's
``io/native.py`` and adds ``decode_jpeg_status``, which returns each
tile's refusal code (``REFUSALS`` names them).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tiledecode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_PATH = BUILD_DIR / "libtiledecode.so"
COMPILE_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fwrapv", "-Wall"]
LINK_LIBS = ["-lz", "-lpthread"]

#: status code of ``decode_jpeg_status`` -> why the tile was refused
REFUSALS = {
    1: "corrupt", 2: "progressive", 3: "arithmetic", 4: "precision", 5: "color",
    6: "sampling", 7: "multiscan", 8: "dimensions", 9: "not_planar",
    10: "unsupported_sof", 11: "bad_huffman_code", 12: "missing_table",
}
FORMS = {"fancy": 0, "nearest": 1, "planar": 2}


def build_command(out: Path | str) -> list[str]:
    """The g++ command line that builds the library into ``out``."""
    return ["g++", *COMPILE_FLAGS, str(SOURCE), "-o", str(out), *LINK_LIBS]


def _fresh() -> bool:
    return LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime


def build_native(force: bool = False) -> Path:
    """Compile ``csrc/tiledecode.cpp`` into ``build/native/libtiledecode.so``
    unless it is there and newer than the source. Raises on failure."""
    if _fresh() and not force:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".buildlock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh() and not force:  # another process built it meanwhile
            return LIB_PATH
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build the tile decoder:\n{proc.stderr}")
            os.replace(tmp, LIB_PATH)
        finally:
            Path(tmp).unlink(missing_ok=True)
    return LIB_PATH


@functools.cache
def _library(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    blobs = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    tables = [ctypes.c_char_p, ctypes.c_size_t]
    hw = [ctypes.c_int, ctypes.c_int]
    vp, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "decode_jpeg_batch": blobs + tables + hw + [vp, i],
        "decode_jpeg_batch_opts": blobs + tables + hw + [vp, i, i],
        "decode_jpeg_batch_planar": blobs + tables + hw + [vp, vp, vp, i],
        "decode_deflate_batch": blobs + hw + [vp, i],
        "decode_jpeg_batch_status": blobs + tables + hw + [i, vp, vp, vp, i],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray | None) -> ctypes.c_void_p | None:
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


class NativeTileDecoder:
    """Threaded batch JPEG/deflate decoder (``num_threads`` 0: one thread
    per core)."""

    def __init__(self, num_threads: int = 0):
        self._lib = _library(str(build_native()))
        self._threads = num_threads

    @staticmethod
    def _blobs(blobs: list[bytes]):
        n = len(blobs)
        return (ctypes.c_char_p * n)(*blobs), (ctypes.c_size_t * n)(*[len(b) for b in blobs]), n

    @staticmethod
    def _tables(jpeg_tables: bytes | None):
        return (jpeg_tables, len(jpeg_tables)) if jpeg_tables else (None, 0)

    def decode_jpeg_status(
        self,
        blobs: list[bytes],
        tile_h: int,
        tile_w: int,
        jpeg_tables: bytes | None = None,
        form: str = "fancy",
    ) -> tuple[tuple[np.ndarray, ...], np.ndarray]:
        """Decode every tile in ``form`` ("fancy" / "nearest" RGB (n, h, w,
        3), or "planar": Y (n, h, w) and CbCr (n, ceil(h/2), ceil(w/2), 2));
        returns (outputs, status (n,) int32), status 0 where the tile
        decoded, else its refusal code (``REFUSALS``). A refused tile's
        output is undefined."""
        arr, sizes, n = self._blobs(blobs)
        if form == "planar":
            outs = (np.empty((n, tile_h, tile_w), np.uint8),
                    np.empty((n, (tile_h + 1) // 2, (tile_w + 1) // 2, 2), np.uint8))
        else:
            outs = (np.empty((n, tile_h, tile_w, 3), np.uint8),)
        status = np.zeros(n, np.int32)
        self._lib.decode_jpeg_batch_status(
            arr, sizes, n, *self._tables(jpeg_tables), tile_h, tile_w, FORMS[form],
            _ptr(outs[0]), _ptr(outs[1]) if len(outs) > 1 else None, _ptr(status),
            self._threads)
        return outs, status

    def decode_jpeg_batch(
        self,
        blobs: list[bytes],
        tile_h: int,
        tile_w: int,
        jpeg_tables: bytes | None = None,
    ) -> np.ndarray | None:
        """RGB with libjpeg's default (fancy) chroma upsampling; None if any
        tile failed."""
        (out,), status = self.decode_jpeg_status(blobs, tile_h, tile_w, jpeg_tables, "fancy")
        return None if status.any() else out

    def decode_jpeg_batch_nearest(
        self,
        blobs: list[bytes],
        tile_h: int,
        tile_w: int,
        jpeg_tables: bytes | None = None,
    ) -> np.ndarray | None:
        """RGB with nearest chroma (libjpeg's merged upsampler): the host
        oracle of the planar feed."""
        (out,), status = self.decode_jpeg_status(blobs, tile_h, tile_w, jpeg_tables, "nearest")
        return None if status.any() else out

    def decode_jpeg_batch_planar(
        self,
        blobs: list[bytes],
        tile_h: int,
        tile_w: int,
        jpeg_tables: bytes | None = None,
        return_ok: bool = False,
    ) -> tuple[np.ndarray, np.ndarray] | tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """Raw 4:2:0 planes, (Y (n, h, w), CbCr (n, ceil(h/2), ceil(w/2), 2))
        uint8, half the bytes of RGB. None if any tile is not plain 4:2:0
        YCbCr of even size; with ``return_ok=True``, (Y, CbCr, ok (n,) bool)
        keeping the tiles that decoded."""
        (y, cbcr), status = self.decode_jpeg_status(blobs, tile_h, tile_w, jpeg_tables, "planar")
        if return_ok:
            return y, cbcr, status == 0
        return None if status.any() else (y, cbcr)

    def decode_deflate_batch(
        self, blobs: list[bytes], tile_h: int, tile_w: int
    ) -> np.ndarray | None:
        arr, sizes, n = self._blobs(blobs)
        out = np.empty((n, tile_h, tile_w, 3), dtype=np.uint8)
        rc = self._lib.decode_deflate_batch(arr, sizes, n, tile_h, tile_w, _ptr(out),
                                            self._threads)
        return None if rc != 0 else out


if __name__ == "__main__":
    print(f"built {build_native(force=True)}: {' '.join(build_command(LIB_PATH))}")
