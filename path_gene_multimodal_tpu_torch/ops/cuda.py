"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (``build/kernels/lib<name>.so``
beside the package, a directory git ignores) and loaded with ``ctypes``.
Nothing is built when this module is imported: ``library(name)`` builds at
first use, and ``build_all()`` starts one ``nvcc`` per source at once.
A library is rebuilt when a source is newer than it.

Wrappers pass tensor pointers (``data_ptr()``) and ``stream(device)``, the
current stream of the device their tensors are on, as ``ctypes.c_void_p``;
``launch`` runs the launcher with that device current (a kernel's
attributes and occupancy are the current device's), and raises unless it
returns ``cudaSuccess``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("convnext_block", "cc_sizes", "flood", "instance_stats", "decoder_conv",
           "upsample_conv", "conv64", "cc", "final_heads_wide")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SMEM_PER_BLOCK = 232_448  # shared memory a block can take on the H100


def gpu_supported(devices=None) -> bool:
    """True when each of the CUDA ``devices`` (default every visible one,
    as a default mesh takes them) has compute capability >= 9.0 (the
    counterpart of the JAX package's ``pallas_supported``)."""
    if not torch.cuda.is_available():
        return False
    if devices is None:
        devices = range(torch.cuda.device_count())
    return all(torch.cuda.get_device_capability(d) >= (9, 0) for d in devices)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (persistent kernels size
    their grid by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@contextlib.contextmanager
def exact_f32():
    """f32 convolutions (cuDNN) and matrix products (cuBLAS) without TF32
    for the duration, whatever the caller's global flags, which are
    restored after. The plain versions of the kernels run under it, so that
    on the card they compute in f32 as the TPU kernels do. Usable as a
    decorator."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def _start_build(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu"),
    ]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.build.log").write_text(out)
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))


def build_all(names=KERNELS) -> None:
    """Compile every stale kernel library, all ``nvcc`` runs in parallel."""
    procs = {n: _start_build(n) for n in names if _stale(n)}
    errors = []
    for n, proc in procs.items():
        try:
            _finish_build(n, proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (register and shared-memory use
    from ``-Xptxas -v``), if it was built in this checkout."""
    p = BUILD_DIR / f"{name}.build.log"
    return p.read_text() if p.exists() else ""


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Load ``lib<name>.so``, building it first if it is missing or stale."""
    if _stale(name):
        build_all((name,))
    lib = ctypes.CDLL(str(_lib_path(name)))
    lib.pgm_error_string.argtypes = [ctypes.c_int]
    lib.pgm_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, fn: str, *args) -> None:
    """Call launcher ``fn`` of library ``name``; arguments are ints (passed
    as ``c_int``) or ``ctypes.c_void_p``, one of them ``stream(device)``,
    whose device is current for the call. Raises on a failed launch."""
    lib = library(name)
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = [type(a) if isinstance(a, ctypes.c_void_p) else ctypes.c_int for a in args]
    dev = next((a.device for a in args if isinstance(a, _Stream)), None)
    if dev is None:
        raise ValueError(f"{name}.{fn}: no stream(device) among the arguments")
    with torch.cuda.device(dev):
        err = f(*args)
    if err != 0:
        msg = lib.pgm_error_string(err).decode()
        raise RuntimeError(f"{name}.{fn}: CUDA error {err} ({msg})")


class LaunchCount:
    """The launches of a kernel route that no wrapper of its own counts,
    read and reset as a wrapper's ``launches`` (K7's any route, its second
    pass; the routes of K2-K4 for the shapes their first kernels do not
    take)."""

    def __init__(self):
        self.launches = 0


def size_query(name: str, fn: str, device: torch.device, *ints: int) -> int:
    """Call a ``size_t f(int, ...)`` helper of library ``name`` with the
    CUDA ``device`` current (occupancy is a device's)."""
    f = getattr(library(name), fn)
    f.restype = ctypes.c_size_t
    f.argtypes = [ctypes.c_int] * len(ints)
    with torch.cuda.device(device):
        return int(f(*ints))


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


class _Stream(ctypes.c_void_p):
    """A stream handle that carries its device, for ``launch``."""

    device: torch.device


def stream(device: torch.device | torch.Tensor) -> ctypes.c_void_p:
    """The current stream of ``device`` (or of the device a tensor is on),
    not of the current device."""
    if torch.is_tensor(device):
        device = device.device
    s = torch.cuda.current_stream(device)
    out = _Stream(s.cuda_stream)
    out.device = s.device
    return out


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``), 32-byte aligned as the kernels' vector and wmma loads need."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 32:
        raise ValueError(f"{name}: expected a 32-byte aligned tensor")
