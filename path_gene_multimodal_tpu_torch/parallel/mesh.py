"""Device mesh and data parallelism over the tile axis.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX package
shards a batch over a 1-D ``jax.sharding.Mesh`` (axis ``"tiles"``),
replicates the weights and lets XLA place the work. Torch has no
partitioner, so the port does it by hand, in one process that drives every
local device:

- a ``Mesh`` is an ordered tuple of devices on one axis; a device may
  appear more than once (several shards on one card, or on the CPU);
- ``replicate`` puts one copy of a module or a tensor tree on each distinct
  device;
- ``run_sharded`` splits a batch on its leading axis into one run of rows a
  shard, in shard order (the first ``n % size`` shards take one row more,
  as ``torch.tensor_split`` splits), and enqueues each shard's work on its
  device's current stream before anything is read back;
- ``gather`` concatenates the shards' outputs in shard order on one device.

Every tile is independent, so a sharded forward computes what the
unsharded one does, tile by tile. ``init_distributed`` joins processes
(one per host, as JAX's multi-host bring-up) through ``torch.distributed``;
the training wrapper (``parallel/train.py::shard_step_over_mesh``) sums
gradients across them.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from path_gene_multimodal_tpu_torch.config import MeshConfig
from path_gene_multimodal_tpu_torch.ops.cuda import gpu_supported

TILE_AXIS = "tiles"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the shards' devices, in shard order, and the axis name."""

    devices: tuple[torch.device, ...]
    axis: str = TILE_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def canonical_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def local_devices(kind: str | torch.device = "cuda") -> list[torch.device]:
    """This process's devices of a kind: every visible CUDA device, or the
    CPU (one device)."""
    if torch.device(kind).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(num_devices: int | None = None, devices=None, axis: str = TILE_AXIS) -> Mesh:
    """The first ``num_devices`` (default all) of ``devices`` (default every
    local CUDA device). Without ``devices`` it needs a CUDA device: it never
    falls back to the CPU. Every CUDA device of the mesh must be a Hopper
    card (``gpu_supported``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a mesh: pass devices= to build one on the CPU")
        devices = local_devices("cuda")
    devices = [canonical_device(d) for d in devices]
    n = len(devices) if num_devices is None else num_devices
    if n <= 0:  # 0/negative would silently slice devices[:n]
        raise ValueError(f"requested {n} devices; need a positive count")
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    cards = [d for d in devices[:n] if d.type == "cuda"]
    if cards and not gpu_supported(cards):
        raise RuntimeError("a mesh device is not a Hopper card: the port's kernels need "
                           "compute capability 9.0")
    return Mesh(tuple(devices[:n]), axis)


def dp_mesh_for_batch(batch_size: int, *, config: MeshConfig | None = None,
                      logger: Any | None = None, label: str = "batch",
                      device: str | torch.device = "cuda") -> Mesh:
    """The shared ``--dp`` CLI bring-up: the mesh of the local devices of
    ``device``'s kind (the CPU is one device), as many as
    ``config.num_devices`` says (None: all) on ``config.data_axis``,
    checked to split ``batch_size`` evenly. Raises ``ValueError`` with the
    JAX package's messages otherwise."""
    config = config or MeshConfig()
    mesh = make_mesh(config.num_devices, devices=local_devices(device), axis=config.data_axis)
    n = mesh.size
    if batch_size % n:
        raise ValueError(
            f"{label} {batch_size} is not a multiple of the {n}-device mesh "
            f"(pick a batch size divisible by {n})"
        )
    if logger is not None:
        logger.info("data-parallel over %d devices (%s %d)", n, label, batch_size)
    return mesh


def on_device(device: torch.device):
    """``device`` current for the duration (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_slices(n: int, shards: int) -> list[slice]:
    """The rows of each shard of an ``n``-row batch, as ``torch.tensor_split``
    cuts it: the first ``n % shards`` shards take one row more."""
    q, r = divmod(n, shards)
    out, lo = [], 0
    for i in range(shards):
        hi = lo + q + (i < r)
        out.append(slice(lo, hi))
        lo = hi
    return out


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to(x, device: torch.device, non_blocking: bool = True):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device, non_blocking=non_blocking) if torch.is_tensor(x) else x


def tree_to(tree: Any, device: torch.device) -> Any:
    """A tree of tensors (and arrays) with every leaf on ``device``; a leaf
    already there is kept as it is."""
    return _tree_map(lambda x: _to(x, device, non_blocking=False), tree)


def shard_batch(batch: Any, mesh: Mesh) -> list[Any]:
    """A host or device batch (a tensor, an array, or a tree of them) → one
    tree a shard, each leaf's rows for that shard on the shard's device; a
    0-d leaf is replicated."""
    leaves: list = []
    _tree_map(leaves.append, batch)
    n = next(np.shape(x)[0] for x in leaves if np.ndim(x))
    out = []
    for dev, sl in zip(mesh.devices, shard_slices(n, mesh.size)):
        out.append(_tree_map(lambda x: _to(x if np.ndim(x) == 0 else x[sl], dev), batch))
    return out


def replicate(obj: Any, mesh: Mesh) -> dict[torch.device, Any]:
    """One copy of a module or a tensor tree per distinct mesh device
    (device → copy): the object itself on the device it is on, copies
    elsewhere (a module with its buffers, a tree leaf by leaf)."""
    out = {}
    for dev in mesh.distinct:
        if isinstance(obj, nn.Module):
            home = next(iter(obj.parameters()), torch.empty(0)).device
            out[dev] = obj if canonical_device(home) == dev else copy.deepcopy(obj).to(dev)
        else:
            out[dev] = tree_to(obj, dev)
    return out


def run_sharded(mesh: Mesh, fn: Callable, *batches: torch.Tensor) -> list[Any]:
    """``fn(device, *rows)`` for each shard that has rows, with its device
    current and its rows of every batch (leading axis) moved there; each
    call only enqueues work, so every shard's work is queued before any of
    it is read back. Returns the outputs in shard order."""
    n = batches[0].shape[0]
    outs = []
    for dev, sl in zip(mesh.devices, shard_slices(n, mesh.size)):
        if sl.start == sl.stop:
            continue
        with on_device(dev):
            outs.append(fn(dev, *(_to(b[sl], dev) for b in batches)))
    return outs


def gather(parts: list[Any], device: torch.device, dim: int = 0) -> Any:
    """The shards' outputs (trees of one structure) concatenated in shard
    order along ``dim`` on ``device``."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: gather([p[k] for p in parts], device, dim) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(gather([p[i] for p in parts], device, dim) for i in range(len(first)))
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=dim)


def pad_to_multiple(arr, multiple: int):
    """Pad the leading axis with zeros to a multiple of ``multiple`` (numpy
    or torch). Returns (padded, original_length)."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad:
        if torch.is_tensor(arr):
            arr = torch.cat([arr, arr.new_zeros((pad, *arr.shape[1:]))])
        else:
            arr = np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)], axis=0)
    return arr, n


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None) -> None:
    """Join ``num_processes`` processes (this one ``process_id``) through
    ``torch.distributed`` at ``coordinator`` (``host:port`` or a ``tcp://``
    address): NCCL when a CUDA device is visible, gloo otherwise, unless
    ``backend`` says. A no-op without a coordinator (one process)."""
    if not coordinator:
        return
    import torch.distributed as dist

    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                            rank=process_id)
