"""K4: per-instance statistics of dense label maps.

Counterpart of the JAX package's ``ops/pallas/instance_stats.py``
(``instance_stats_pallas``, ``stats_center``, ``features_from_stats``). On
CUDA tensors ``instance_stats`` launches ``csrc/instance_stats.cu``; on CPU
tensors it runs ``instance_stats_plain``. Output layout as the TPU
kernel's: sums (B, S, c_sum) f32 with channels [count, sum x, sum y,
sum (x-sx)^2, sum (y-sy)^2, sum (x-sx)(y-sy), votes of types
1..num_types-1, zero padding to a multiple of 8], mins (B, 4, S) f32 rows
[xmin, ymin, -xmax, -ymax] (3e38 for empty slots). Slot 0 carries the
background; ids outside [0, S) are ignored. Both sum exact integers and
round to f32 once, so the kernel equals the plain version bit for bit.

The kernel cuts each row into spans of 8 pixels, a lane each, sums runs of
equal id (joined across the lanes of a warp), and splits each tile's rows
over a thread-block cluster whose blocks merge their slot tables through
distributed shared memory; ``InstanceStatsTiling`` is its geometry. It
takes 2..9 types and tables that fit a block's shared memory; every other
shape the TPU kernel takes (any slot count, any ``num_types >= 1``) runs
the kernel's table route, whose slot table lives in device memory
(``InstanceStatsTiling.route``; its launches are ``TABLE_LAUNCHES``'s).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import ClassVar

import torch

from path_gene_multimodal_tpu_torch.ops import cuda

_N_FIXED = 6
_BIG = 3e38


def stats_center(h: int, w: int) -> tuple[float, float]:
    """The (sx, sy) the second moments are taken about."""
    return w / 2.0, h / 2.0


def _c_sum(num_types: int) -> int:
    return ((_N_FIXED + num_types - 1 + 7) // 8) * 8


def instance_stats_plain(
    inst_maps: torch.Tensor, type_maps: torch.Tensor, max_instances: int = 512,
    num_types: int = 6,
):
    """Exact integer segment sums (int64), converted to f32 once."""
    b, h, w = inst_maps.shape
    _check_moments(h, w)
    s = max_instances
    dev = inst_maps.device
    lbl = inst_maps.reshape(b, h * w).long()
    tp = type_maps.reshape(b, h * w).long()
    valid = (lbl >= 0) & (lbl < s)
    idx = torch.where(valid, lbl, s)
    pix = torch.arange(h * w, device=dev)
    x = (pix % w).expand(b, -1)
    y = (pix // w).expand(b, -1)
    dx = 2 * x - w
    dy = 2 * y - h
    vals = [torch.ones_like(x), x, y, dx * dx, dy * dy, dx * dy]
    vals += [(tp == t).long() for t in range(1, num_types)]

    def seg_sum(v):
        out = torch.zeros((b, s + 1), dtype=torch.int64, device=dev)
        return out.scatter_add_(1, idx, v.expand(b, -1).contiguous())[:, :s]

    c_sum = _c_sum(num_types)
    sums = torch.zeros((b, s, c_sum), dtype=torch.float32, device=dev)
    for c, v in enumerate(vals):
        t = seg_sum(v)
        sums[..., c] = (t.double() * 0.25).float() if c in (3, 4, 5) else t.float()

    def seg_ext(v, op):
        fill = torch.iinfo(torch.int64).max if op == "amin" else torch.iinfo(torch.int64).min
        out = torch.full((b, s + 1), fill, dtype=torch.int64, device=dev)
        return out.scatter_reduce(1, idx, v.contiguous(), op)[:, :s]

    live = sums[..., 0] > 0
    rows = [seg_ext(x, "amin"), seg_ext(y, "amin"), -seg_ext(x, "amax"), -seg_ext(y, "amax")]
    mins = torch.stack([torch.where(live, r.float(), _BIG) for r in rows], dim=1)
    return sums, mins


CLUSTERS = (1, 2, 4, 8)  # portable thread-block cluster sizes


@dataclass(frozen=True)
class InstanceStatsTiling:
    """Launch geometry of K4 (``csrc/instance_stats.cu``) on (batch, h, w)
    maps with ``slots`` slots and ``num_types`` types.

    ``route`` "cluster" (2..9 types, a table that fits a block's shared
    memory): each tile's rows cut into bands of ``band``
    rows, dealt in turn to the ``cluster`` blocks of ``threads`` of a tile
    (block r takes bands r, r + cluster, ...), the blocks of a tile one
    thread-block cluster; each block holds a slot table in shared memory
    (32-bit sums where the tile is ``narrow``, its lanes' slot-0 records
    beside it: ``smem_bytes`` in all), and rank r owns slots [r, r + 1) *
    ``owner_chunk`` of the merged table. A lane takes a span of ``span`` pixels of a row
    (``spans_per_row`` a row), whole spans by 16-byte loads where rows are
    16-byte aligned (``vector_rows``).

    ``cluster`` is the largest whose grid is one wave of at most
    ``resident_blocks`` blocks on each of the card's ``sms``
    multiprocessors (a tile alone gives too few blocks: 128 tiles on 132
    SMs take clusters of 2), no larger than the tile has rows.

    ``route`` "table" (every other shape): the slot table in device memory
    (``table_bytes``), each thread a chunk of ``chunk`` pixels of a row,
    ``table_blocks`` blocks of ``table_threads`` an image, ``table_grid``
    blocks for the table's first and last pass.

    The kernel checks what it is given against its own geometry; only an
    empty input, a tile of 2^31 pixels or more and a tile whose moments
    pass 64 bits (``_check_moments``) are refused."""

    threads: ClassVar[int] = 512
    span: ClassVar[int] = 8
    band: ClassVar[int] = 8
    chunk: ClassVar[int] = 16
    table_threads: ClassVar[int] = 256

    batch: int
    h: int
    w: int
    slots: int = 512
    num_types: int = 6
    sms: int = 132

    def __post_init__(self):
        if min(self.batch, self.h, self.w, self.slots, self.num_types) <= 0:
            raise ValueError(f"instance_stats: empty input {self.batch}x{self.h}x{self.w}, "
                             f"{self.slots} slots, {self.num_types} types")
        if self.h * self.w >= 2**31:
            raise ValueError(f"instance_stats: a {self.h}x{self.w} tile has 2^31 pixels or more")
        _check_moments(self.h, self.w)

    @functools.cached_property
    def route(self) -> str:
        """"cluster": the cluster kernel (2..9 types, its table in a block's
        shared memory; its sides under 2^27 hold for every tile
        ``_check_moments`` passes); "table": the table route."""
        fits = 2 <= self.num_types <= 9 and self.smem_bytes <= cuda.SMEM_PER_BLOCK
        return "cluster" if fits else "table"

    @functools.cached_property
    def narrow(self) -> bool:
        """Whether every sum of a slot stays under 2^31, so that the table's
        sums are 32-bit (native shared-memory atomics; 64-bit adds run as
        compare-and-swap loops on the card): the tile's sums of x, y,
        (2x - w)^2 and (2y - h)^2 bound a slot's, and by Cauchy-Schwarz its
        cross moment. Tiles up to about 280^2."""
        h, w, lim = self.h, self.w, 2**31 - 1
        if h * w * w >= lim or w * h * h >= lim:
            return False
        return h * _row_moment(w) < lim and w * _row_moment(h) < lim

    @functools.cached_property
    def resident_blocks(self) -> int:
        """Blocks an SM holds at once: 2 with 32-bit sums (the kernel's
        launch bounds cap it at 64 registers), 1 with 64-bit ones (112)."""
        return 2 if self.narrow else 1

    @functools.cached_property
    def smem_bytes(self) -> int:
        """The slot table (five sums of 4 or 8 bytes, the count, the votes and
        four extrema a slot) and, with 32-bit sums, each lane's slot-0
        record (15 words)."""
        table = self.slots * (5 * (4 if self.narrow else 8) + 4 * (1 + (self.num_types - 1) + 4))
        return table + (self.threads * 15 * 4 if self.narrow else 0)

    @functools.cached_property
    def cluster(self) -> int:
        fit = [k for k in CLUSTERS if k <= self.h]
        return max([k for k in fit if self.batch * k <= self.resident_blocks * self.sms],
                   default=fit[0])

    @property
    def spans_per_row(self) -> int:
        return -(-self.w // self.span)

    @property
    def vector_rows(self) -> bool:
        return self.w % 4 == 0

    @property
    def owner_chunk(self) -> int:
        return -(-self.slots // self.cluster)

    def launch_args(self) -> tuple[int, int, int, int, int]:
        """As ``instance_stats_launch`` takes them: cluster, rows a band,
        whole spans by vector loads, 64-bit sums, shared memory bytes."""
        return self.cluster, self.band, int(self.vector_rows), int(not self.narrow), self.smem_bytes

    @property
    def table_bytes(self) -> int:
        """The table route's device table: [batch][5][slots] int64 sums,
        then [batch][1 + (num_types - 1) + 4][slots] int32 (count, votes,
        extrema)."""
        return self.batch * self.slots * (5 * 8 + (4 + self.num_types) * 4)

    @property
    def table_blocks(self) -> int:
        """Blocks an image of the table route's statistics pass: its chunks'
        blocks, no more than one wave of 8 blocks an SM over the batch."""
        chunks = self.h * -(-self.w // self.chunk)
        return max(1, min(-(-chunks // self.table_threads), -(-8 * self.sms // self.batch)))

    @property
    def table_grid(self) -> int:
        """Blocks of the table route's first and last pass (grid-stride)."""
        return max(1, min(-(-self.batch * self.slots // self.table_threads), 8 * self.sms))

    def table_args(self) -> tuple[int, int, int]:
        """As ``instance_stats_table_launch`` takes them: whole chunks by
        vector loads, blocks an image, grid of the table's passes."""
        return int(self.vector_rows), self.table_blocks, self.table_grid


def _row_moment(n: int) -> int:
    """sum_{x < n} (2x - n)^2: the sum of (2x - w)^2 over a whole row."""
    return 4 * ((n - 1) * n * (2 * n - 1) // 6) - 2 * n * n * (n - 1) + n**3


def _check_moments(h: int, w: int) -> None:
    """Refuse a tile whose moments pass the kernel's 64-bit sums: h times a
    row's sum of (2x - w)^2 bounds a slot's, w times a column's its sum of
    (2y - h)^2, and by Cauchy-Schwarz its cross moment. Square tiles pass
    up to 2^31 pixels; a single row up to about 3 million pixels."""
    if h * _row_moment(w) >= 2**63 or w * _row_moment(h) >= 2**63:
        raise ValueError(f"instance_stats: a {h}x{w} tile's moments reach 2^63 (h * sum (2x - w)^2 "
                         f"or w * sum (2y - h)^2), past the kernel's 64-bit sums")


@functools.cache
def tiling(b: int, h: int, w: int, slots: int, num_types: int, sms: int) -> InstanceStatsTiling:
    """The wrapper's geometries, built once each (a call's host time)."""
    return InstanceStatsTiling(b, h, w, slots, num_types, sms)


@functools.cache
def _sms(index: int) -> int:
    return cuda.sm_count(torch.device("cuda", index))


def _launch(lbl, tp, sums, mins, geo: InstanceStatsTiling) -> None:
    cuda.launch(
        "instance_stats", "instance_stats_launch",
        cuda.ptr(lbl), cuda.ptr(tp), cuda.ptr(sums), cuda.ptr(mins), geo.batch, geo.h, geo.w,
        geo.slots, geo.num_types, _c_sum(geo.num_types), *geo.launch_args(), cuda.stream(lbl),
    )


def _launch_table(lbl, tp, sums, mins, geo: InstanceStatsTiling) -> None:
    table = torch.empty(-(-geo.table_bytes // 8), dtype=torch.int64, device=lbl.device)
    cuda.launch(
        "instance_stats", "instance_stats_table_launch",
        cuda.ptr(lbl), cuda.ptr(tp), cuda.ptr(sums), cuda.ptr(mins), cuda.ptr(table), geo.batch,
        geo.h, geo.w, geo.slots, geo.num_types, _c_sum(geo.num_types), *geo.table_args(),
        cuda.stream(lbl),
    )


def instance_stats(
    inst_maps: torch.Tensor, type_maps: torch.Tensor, max_instances: int = 512,
    num_types: int = 6,
):
    """(B, H, W) dense labels + types → (sums, mins): the CUDA kernel on
    CUDA tensors (one launch of its cluster route, counted in
    ``instance_stats.launches``, or of its table route, counted in
    ``TABLE_LAUNCHES``), the plain version on CPU tensors."""
    if not inst_maps.is_cuda:
        return instance_stats_plain(inst_maps, type_maps, max_instances, num_types)
    b, h, w = inst_maps.shape
    geo = tiling(b, h, w, max_instances, num_types, _sms(inst_maps.device.index or 0))
    lbl = inst_maps.to(torch.int32).contiguous()
    tp = type_maps.to(torch.int32).contiguous()
    cuda.check(lbl, "inst_maps", torch.int32, (b, h, w))
    cuda.check(tp, "type_maps", torch.int32, (b, h, w))
    sums = torch.empty((b, max_instances, _c_sum(num_types)), dtype=torch.float32,
                       device=lbl.device)
    mins = torch.empty((b, 4, max_instances), dtype=torch.float32, device=lbl.device)
    if geo.route == "cluster":
        _launch(lbl, tp, sums, mins, geo)
        instance_stats.launches += 1
    else:
        _launch_table(lbl, tp, sums, mins, geo)
        TABLE_LAUNCHES.launches += 1
    return sums, mins


instance_stats.launches = 0
TABLE_LAUNCHES = cuda.LaunchCount()


def features_from_stats(
    sums: torch.Tensor, mins: torch.Tensor, num_types: int,
    center: tuple[float, float] = (0.0, 0.0),
) -> dict[str, torch.Tensor]:
    """(B, S, c_sum) + (B, 4, S) → the ``instance_features_batch`` dict
    (elementwise on the small stats tensors). ``center`` must be the
    ``stats_center`` of the maps the stats came from."""
    sums = sums.clone()
    sums[:, 0, :] = 0.0  # background slot
    area = sums[..., 0]
    safe = torch.clamp(area, min=1.0)
    cx = sums[..., 1] / safe
    cy = sums[..., 2] / safe
    live = area > 0
    cxs, cys = cx - center[0], cy - center[1]
    mu_xx = torch.where(live, sums[..., 3] / safe - cxs * cxs, 0.0)
    mu_yy = torch.where(live, sums[..., 4] / safe - cys * cys, 0.0)
    mu_xy = torch.where(live, sums[..., 5] / safe - cxs * cys, 0.0)
    common = torch.sqrt(torch.clamp(((mu_xx - mu_yy) / 2) ** 2 + mu_xy**2, min=0.0))
    lam1 = torch.clamp((mu_xx + mu_yy) / 2 + common, min=0.0)
    lam2 = torch.clamp((mu_xx + mu_yy) / 2 - common, min=0.0)
    votes = sums[..., _N_FIXED : _N_FIXED + num_types - 1]
    inst_type = torch.where(votes.sum(-1) > 0, votes.argmax(-1) + 1, 0).to(torch.int32)
    z = torch.zeros_like(area)
    return {
        "area": area,
        "centroid_x": torch.where(live, cx, 0.0),
        "centroid_y": torch.where(live, cy, 0.0),
        "bbox_xmin": torch.where(live, mins[:, 0, :], z),
        "bbox_ymin": torch.where(live, mins[:, 1, :], z),
        "bbox_xmax": torch.where(live, -mins[:, 2, :] + 1.0, z),
        "bbox_ymax": torch.where(live, -mins[:, 3, :] + 1.0, z),
        "type": inst_type,
        "major_axis": 4.0 * torch.sqrt(lam1),
        "minor_axis": 4.0 * torch.sqrt(lam2),
        "eccentricity": torch.sqrt(torch.clamp(1.0 - lam2 / torch.clamp(lam1, min=1e-12), min=0.0)),
        "orientation": 0.5 * torch.atan2(2.0 * mu_xy, mu_xx - mu_yy),
    }
