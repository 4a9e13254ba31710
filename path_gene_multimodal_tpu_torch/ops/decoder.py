"""K7-K11: the HoverNeXt decoder and final-stage kernels.

Counterpart of the JAX package's ``ops/pallas/decoder.py``. Each wrapper
launches its hand-written kernel (K7: ``csrc/decoder_conv.cu``; K9, K10:
``csrc/upsample_conv.cu``; K8, K11: ``csrc/conv64.cu``; the last two share
the 64-channel conv core ``csrc/conv64.cuh``; K8-K11 at other widths:
``csrc/final_heads_wide.cu``) on a CUDA tensor and runs its ``*_plain``
twin on a CPU tensor:

- ``decoder_conv`` (K7, ``fused_decoder_conv``): conv3x3(concat(x, skip))
  + bias + LayerNorm + GELU, the concat never built (``DecoderConvTiling``
  is the launch geometry, ``k7_weight_layout`` the weight's layout);
- ``final_conv_gelu`` (K8, ``fused_final_conv_gelu``): conv3x3 + bias + GELU
  (``StripTiling`` is the launch geometry);
- ``upsample_final`` (K9, ``fused_upsample_final``): bilinear 2x + conv3x3 +
  bias + GELU, the upsampled map never built (each tile's halo is
  upsampled once in shared memory; ``UpsampleTiling`` is the launch
  geometry);
- ``final_heads`` (K10, ``fused_final_heads``): bilinear 2x + conv3x3 +
  bias + GELU + head product, logits NHWC (the JAX kernel writes NCHW,
  which its caller transposes to this);
- ``composite_final_heads`` (K11, ``composite_final_heads``): conv3x3 with
  parity-folded weights + bias + GELU + head product; given a head the
  caller states block-diagonal, the kernel runs each parity phase as its
  own 64-channel conv with its diagonal head block (``StripTiling`` with
  four phases).

Each takes every width its Pallas kernel takes. Where its own kernel is
compiled for fewer (K7: cout in ``KERNEL_COUTS``, cx and cs multiples of
32; K8-K11: cin = cout = 64, at most 16 head columns, K11 a block-diagonal
head), K8-K11 run the wide kernel (``csrc/final_heads_wide.cu``,
``HeadTiling``; route "wide"): the conv in N chunks on wgmma; K8 and K9
store each chunk's bias + GELU as it is done (any cout), K10 and K11
multiply it by its head rows on the tensor cores in the epilogue, for
heads of up to ``HEAD_COLS_MAX`` columns summed at once; no f32
scratch. Every other shape runs K7's any route (``csrc/decoder_conv.cu``,
``DecoderConvTiling`` with ``route == "any"``): the weights zero-padded to
the next compiled tile width, past 384 columns (and for a head) f32
conv + bias and a second pass for LayerNorm, GELU and the head
(``conv_epilogue_plain`` its plain twin). These routes' launches are
counted where they are made, apart from the wrappers' own:
``WIDE_LAUNCHES[wrapper]`` one a call, ``ANY_LAUNCHES[wrapper]`` one a
column chunk, ``EPILOGUE_LAUNCHES`` the second pass's. The any route's
column chunks take any width; the one limit is a head's: its second pass
stages a pixel's bf16 conv output in shared memory, so a head's input past
``HEAD_MAX_WIDTH`` channels is refused by the kernel's tiling class, which
names the kernel and the limit.

The plain versions repeat the TPU kernels' rounding points: inputs,
weights and vectors rounded to bf16, f32 sums, bf16 outputs; K10 rounds its
upsampled input and K10/K11 their GELU output to bf16 before the next
product; GELU through ``gelu_kernel`` (the TPU kernel's erf polynomial in
exact mode). Their f32 convolutions (``F.conv2d``) and products run with
TF32 off whatever the caller's flags (``cuda.exact_f32``). K9 and K10 round
their upsampled input to bf16.

``upsample2x_nearest`` and ``upsample2x_bilinear`` are plain torch, as in
the JAX package they are XLA (exact ``jax.image.resize`` semantics at 2x).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.ops import cuda
from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu_kernel

_BF = torch.bfloat16
KERNEL_COUTS = (64, 96, 192, 384)  # K7's tile widths
CIN_MULTIPLE = 32  # input channels per K chunk of K7
UP_CHANNELS = 64  # K8-K11's own kernels: cin = cout (per phase, K11)
UP_HEAD_COLS = 16  # K10/K11's own kernels: head columns (per phase, K11), zero-padded
K11_PHASES = 4  # the parity phases of K11's composite weights
FINAL_CONV_ROWS = 32  # K8: the TPU kernel's default strip (H % rows == 0)
SMEM_PER_BLOCK = cuda.SMEM_PER_BLOCK
# the widest conv output a head's second pass takes (K10; K11 over its
# phases): one pixel's bf16 row in a block's shared memory
HEAD_MAX_WIDTH = SMEM_PER_BLOCK // 2
# the wide head route's head columns summed at once (K10; K11 per phase, or
# over its four phases with a full head): its f32 sums, 2 rows x 80 columns
# a thread, live in registers across the N chunks
HEAD_COLS_MAX = 80
SRC_MODES = {"tma": 0, "plain": 1, "upsample": 2}  # how K7's any route lands a source


def k7_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """K7's weight (3, 3, K, cout) as the kernel reads it: (K / 32, 9, 4,
    cout, 8), chunk c of 32 input channels, tap dy * 3 + dx, 8-channel plane,
    output channel, channel within the plane (wgmma's canonical K-major B),
    so that the k-slice of (chunk, taps) is contiguous. The skip's rows (K
    from cx on) follow x's as they do in w."""
    k, cout = w.shape[2], w.shape[3]
    return (w.reshape(9, k // CIN_MULTIPLE, 4, 8, cout).permute(1, 0, 2, 4, 3)
            .contiguous())


def k7_weight_layout_any(w: torch.Tensor, geo: "DecoderConvTiling") -> torch.Tensor:
    """K7's any route's weight: w (3, 3, cx + cs, cout) zero-padded to x's
    and the skip's whole 32-channel chunks (the skip's rows from x's last
    chunk's end on) and to ``n_chunks`` column chunks of ``n_tile``, each
    chunk laid out as ``k7_weight_layout``: (n_chunks, K / 32, 9, 4,
    n_tile, 8)."""
    (nx, ns), k = geo.chunks, geo.k_chunk
    wp = w.new_zeros((3, 3, (nx + ns) * k, geo.n_chunks * geo.n_tile))
    wp[:, :, : geo.cx, : geo.cout] = w[:, :, : geo.cx]
    wp[:, :, nx * k : nx * k + geo.cs, : geo.cout] = w[:, :, geo.cx :]
    return torch.stack([k7_weight_layout(c) for c in wp.split(geo.n_tile, -1)])


# K7's geometry per cout: cout split over the two consumer warpgroups (2)
# or not (1), m64 blocks (8 x 8 pixels) per warpgroup, tile rows and
# columns, taps per weight slice, weight and halo ring slots
_K7_GEOMETRY = {
    384: (2, 1, 8, 8, 1, 8, 2),
    192: (1, 1, 8, 16, 3, 4, 2),
    96: (1, 2, 16, 16, 3, 6, 3),
    64: (1, 2, 16, 16, 3, 6, 3),
}


@dataclass(frozen=True)
class DecoderConvTiling:
    """Launch geometry of the K7 kernel (``csrc/decoder_conv.cu``) on x
    (batch, h, w, cx) and skip (batch, h, w, cs), cout output channels.

    Output tiles of tile_h x tile_w pixels of one image (images, tile rows,
    tile columns; ragged tiles at the right and bottom edge) each cover all
    of cout. A tile is cut into 8 x 8 pixel blocks, one wgmma M tile each:
    the two consumer warpgroups split cout between them on one block
    (``split`` 2, cout 384) or take ``m_tiles`` blocks each. K runs over
    (32-channel chunk, tap): the chunks of x, then the skip's (whose weight
    rows start at cx). Per chunk the tile's halo, (tile_h + 2) x (tile_w +
    2) pixels x 32 channels, origin one pixel up and left of the tile (zero
    outside the image: the conv's padding), lands in one of ``ring_h``
    slots; the weight streams in slices of ``taps`` taps x 32 channels x
    cout through ``ring_w`` slots. ``cluster`` blocks on consecutive tiles
    (a group) share each slice: block ``rank`` copies the slice's rank-th
    part into every block of the cluster. Persistent: ``grid`` blocks,
    whole clusters, no more than ``slots`` (the blocks that fit the card at
    once); cluster k walks groups k, k + grid / cluster, ...; a block whose
    tile passes the last one repeats the last and writes nothing. The
    kernel is compiled for this geometry and checks what it is given
    against its own.

    ``route``: "fixed" where cout is one of ``KERNEL_COUTS`` and cx, cs are
    multiples of 32; else "any" (also for K9/K10's upsampled input and the
    final stage's heads): the kernel at tile width ``n_tile`` over
    ``n_chunks`` column chunks, its K and N zero-padded
    (``k7_weight_layout_any``), each source's halo landing as
    ``source_modes`` says, and where ``raw`` f32 conv + bias finished by
    the second pass (``conv_epilogue_launch``)."""

    k_chunk: ClassVar[int] = CIN_MULTIPLE
    cluster: ClassVar[int] = 2  # clusters of 4 ran slower: fewer of them fit the card at once

    batch: int
    h: int
    w: int
    cx: int
    cs: int
    cout: int
    slots: int = 132
    upsample: bool = False  # x at (h / 2, w / 2), the conv's input its bilinear 2x (K9/K10)
    second_pass: bool = False  # f32 conv + bias out, finished by conv_epilogue (a head)
    kernel: str = "decoder_conv"  # the wrapper it runs for, named in a refusal

    def __post_init__(self):
        if (min(self.batch, self.h, self.w, self.cx, self.cout) <= 0 or self.cs < 0
                or (self.second_pass and self.cout > HEAD_MAX_WIDTH)
                or (self.upsample and (self.cs or self.h % 2 or self.w % 2))):
            raise ValueError(
                f"{self.kernel} kernel takes input channels >= 1, cout >= 1 and, with a head, "
                f"cout <= {HEAD_MAX_WIDTH} (HEAD_MAX_WIDTH), got cin {[self.cx, self.cs]}, "
                f"cout {self.cout}, shape {self.batch}x{self.h}x{self.w}")

    @property
    def route(self) -> str:
        """"fixed": the kernel compiled for this cout (cx and cs multiples of
        32); "any": the any route, at tile width ``n_tile``."""
        fixed = (self.cout in KERNEL_COUTS and not (self.cx % CIN_MULTIPLE or
                                                    self.cs % CIN_MULTIPLE)
                 and not (self.upsample or self.second_pass))
        return "fixed" if fixed else "any"

    @property
    def n_tile(self) -> int:
        """The compiled tile width the kernel runs at: the smallest at or
        above cout, or the widest, in ``n_chunks`` column chunks."""
        return next((n for n in KERNEL_COUTS if n >= self.cout), KERNEL_COUTS[-1])

    @property
    def n_chunks(self) -> int:
        return -(-self.cout // self.n_tile)

    @property
    def raw(self) -> bool:
        """Whether the kernel writes f32 conv + bias for ``conv_epilogue``
        (past one tile's columns, or for a head) instead of finishing."""
        return self.second_pass or self.n_chunks > 1

    def source_modes(self) -> tuple[str, str]:
        """How the halo chunks of x and of the skip land: by TMA where the
        rows are whole 16-B groups, else by the producer warp's loads;
        x's bilinear 2x always by the producer warp."""
        mode = lambda c: "tma" if c % 8 == 0 else "plain"  # noqa: E731
        return ("upsample" if self.upsample else mode(self.cx)), mode(self.cs)

    @property
    def in_hw(self) -> tuple[int, int]:
        """The resolution of x (half the conv's with ``upsample``)."""
        return (self.h // 2, self.w // 2) if self.upsample else (self.h, self.w)

    @property
    def _geo(self) -> tuple[int, ...]:
        return _K7_GEOMETRY[self.n_tile]

    split = property(lambda self: self._geo[0])
    m_tiles = property(lambda self: self._geo[1])
    tile_h = property(lambda self: self._geo[2])
    tile_w = property(lambda self: self._geo[3])
    taps = property(lambda self: self._geo[4])
    ring_w = property(lambda self: self._geo[5])
    ring_h = property(lambda self: self._geo[6])

    @property
    def n_width(self) -> int:
        """Output channels of one warpgroup's accumulators."""
        return self.n_tile // self.split

    @property
    def tiles_yx(self) -> tuple[int, int]:
        return -(-self.h // self.tile_h), -(-self.w // self.tile_w)

    @property
    def n_tiles(self) -> int:
        ty, tx = self.tiles_yx
        return self.batch * ty * tx

    @property
    def groups(self) -> int:
        return -(-self.n_tiles // self.cluster)

    @property
    def grid(self) -> int:
        return self.cluster * min(self.groups, self.slots // self.cluster)

    @property
    def chunks(self) -> tuple[int, int]:
        """32-channel chunks of x and of the skip (the last one of each
        zero-padded)."""
        return -(-self.cx // self.k_chunk), -(-self.cs // self.k_chunk)

    def tile(self, t: int) -> tuple[int, int, int]:
        """(image, first row, first column) of tile t."""
        ty_n, tx_n = self.tiles_yx
        img, rem = divmod(t, ty_n * tx_n)
        ty, tx = divmod(rem, tx_n)
        return img, ty * self.tile_h, tx * self.tile_w

    def block_tiles(self, block: int) -> list[tuple[int, bool]]:
        """(tile, writes) in the order block ``block`` walks them."""
        k, rank = divmod(block, self.cluster)
        stride = self.grid // self.cluster
        return [(min(g * self.cluster + rank, self.n_tiles - 1),
                 g * self.cluster + rank < self.n_tiles)
                for g in range(k, self.groups, stride)]

    def warpgroup_blocks(self, group: int) -> list[tuple[int, int, int]]:
        """(block row, block column, first output channel) of the 8 x 8
        pixel blocks whose products warpgroup ``group`` holds."""
        bx_n = self.tile_w // 8
        if self.split == 2:
            return [(0, 0, group * self.n_width)]
        return [(*divmod(group * self.m_tiles + m, bx_n), 0) for m in range(self.m_tiles)]

    def k_slices(self) -> list[tuple[int, int, int, int, tuple[int, ...]]]:
        """Per weight slice, in the kernel's order: (chunk, source (0 x, 1
        skip), first channel in the source, first weight row of the padded
        K (``k7_weight_layout_any``), taps)."""
        nx, ns = self.chunks
        out = []
        for c in range(nx + ns):
            src, c0 = (0, c) if c < nx else (1, c - nx)
            for s in range(9 // self.taps):
                taps = tuple(range(s * self.taps, (s + 1) * self.taps))
                out.append((c, src, c0 * self.k_chunk, c * self.k_chunk, taps))
        return out

    @property
    def slice_bytes(self) -> int:
        return self.taps * self.k_chunk * self.n_tile * 2

    def multicast_parts(self) -> list[tuple[int, int]]:
        """(byte offset, bytes) of the part of each slice that each rank of
        a cluster copies into every block of it."""
        part = self.slice_bytes // self.cluster
        return [(r * part, part) for r in range(self.cluster)]

    @property
    def halo_shape(self) -> tuple[int, int]:
        return self.tile_h + 2, self.tile_w + 2

    @property
    def halo_bytes(self) -> int:
        hh, hw = self.halo_shape
        return hh * hw * self.k_chunk * 2

    @property
    def smem_bytes(self) -> int:
        """The weight ring, the halo ring, a staging of 16 pixels x (32 + 8)
        bf16 per consumer warp, the LayerNorm partial sums (2 passes x 2
        warpgroups x 64 rows, f32) and an mbarrier per slot, full and
        empty."""
        staging = 8 * 16 * (self.k_chunk + 8) * 2
        return (self.ring_w * self.slice_bytes + self.ring_h * self.halo_bytes + staging
                + 2 * 2 * 64 * 4 + 2 * (self.ring_w + self.ring_h) * 8)

    def l2_bytes(self) -> dict[str, int]:
        """Bytes the call reads through L2: each group reads the whole
        weight once (its blocks share it), each block a halo per chunk of
        each tile it walks (repeats included)."""
        nx, ns = self.chunks
        weights = 9 * (nx + ns) * self.k_chunk * self.n_tile * 2
        return {"weights": self.n_chunks * self.groups * weights,
                "activations": self.n_chunks * self.groups * self.cluster * (nx + ns)
                * self.halo_bytes}

    def launch_args(self) -> tuple[int, ...]:
        """(tile_h, tile_w, taps, ring_w, ring_h, cluster, grid, shared
        memory bytes), as the launcher takes them."""
        return (self.tile_h, self.tile_w, self.taps, self.ring_w, self.ring_h, self.cluster,
                self.grid, self.smem_bytes)


@dataclass(frozen=True)
class HeadTiling:
    """Launch geometry of the wide kernel (``csrc/final_heads_wide.cu``):
    K9 and K10 (``upsample``: x at (h / 2, w / 2), the conv's input its
    bilinear 2x), K8 and K11 at the shapes their own kernels do not take,
    on a conv of (batch, h, w) output pixels, cin input channels and, per
    phase, cout conv columns and n_out head columns (K11 stated
    block-diagonal: 4 phases of (cout, n_out); K11 with a full head: one
    phase of (4 cout, 4 n_out); K10: one phase; K8 and K9: one phase and
    no head, ``n_out`` 0).

    Persistent blocks, one per SM, block b running phase b % phases and
    walking output tiles t = b // phases, += grid / phases (images, tile
    rows, tile columns) of tile_h x tile_w pixels; each of the two
    warpgroups owns ``rows`` tile rows, one m64 wgmma tile each. cin is
    zero-padded to ``cin_p`` (16-channel steps) and walked in ``k_chunks``
    of at most ``k_max`` channels; per chunk the tile's halo (``halo_shape``
    at ``halo_origin``: K11 copied, K10 upsampled from the low-res window
    ``window_shape`` at ``window_origin``) lands planar. cout is zero-padded
    to ``cout_p`` and walked in ``n_chunks`` of at most ``n_max`` columns;
    each N chunk's k-slices (9 taps x 16 input channels x its columns,
    ``head_weight_layout``) come through a ring of ``ring`` slots, resident
    where all ``slices`` fit it. After each N chunk its bias + GELU, rounded
    to bf16, multiply the chunk's head rows into ``cols_p`` f32 sums a pixel,
    kept across the chunks: ``n_out`` is at most ``HEAD_COLS_MAX``. Without
    a head each N chunk's bias + GELU, rounded to bf16, is stored at its
    column offset as soon as it is done (any cout), in N chunks of
    ``n_max`` 64 or 128 columns (with a head 64). The kernel is compiled
    for this tile and checks what it is given against its own layout;
    ``fits`` says whether the shape takes this route."""

    tile_h: ClassVar[int] = 4
    tile_w: ClassVar[int] = 64
    rows: ClassVar[int] = 2   # m64 rows per warpgroup
    warps: ClassVar[int] = 8
    k_max: ClassVar[int] = 64
    max_ring: ClassVar[int] = 8

    batch: int
    h: int
    w: int
    cin: int
    cout: int
    n_out: int
    phases: int = 1
    upsample: bool = False
    n_sm: int = 132
    kernel: str = "final_heads"  # the wrapper it runs for
    n_max: int = 64  # conv columns of an N chunk, at most (128 only without a head)

    def __post_init__(self):
        if self.n_max not in (64, 128) or (self.head and self.n_max != 64):
            raise ValueError(f"{self.kernel}: the wide kernel takes N chunks of 64 columns, or "
                             f"128 without a head, got {self.n_max} (n_out {self.n_out})")

    head = property(lambda self: self.n_out > 0)
    cin_p = property(lambda self: -(-self.cin // 16) * 16)
    cout_p = property(lambda self: -(-self.cout // 16) * 16)
    cols_p = property(lambda self: -(-self.n_out // 16) * 16)

    @property
    def k_chunks(self) -> list[tuple[int, int]]:
        """(first channel, channels) of each K chunk of the padded cin: the
        fewest chunks of at most ``k_max``, as even as 16-channel steps allow
        (the last may be narrower)."""
        n = -(-self.cin_p // self.k_max)
        kw = 16 * -(-(self.cin_p // 16) // n)
        return [(c0, min(kw, self.cin_p - c0)) for c0 in range(0, self.cin_p, kw)]

    @property
    def n_chunks(self) -> list[tuple[int, int]]:
        """(first column, columns) of each N chunk of the padded cout."""
        return [(n0, min(self.n_max, self.cout_p - n0))
                for n0 in range(0, self.cout_p, self.n_max)]

    @property
    def slices(self) -> int:
        """k-slices a tile's products read: per N chunk, one per 16 input
        channels."""
        return len(self.n_chunks) * self.cin_p // 16

    def slice_order(self) -> list[tuple[int, int]]:
        """(N chunk, 16-channel step) of each slice, in the order a tile
        reads them (the ring's order)."""
        return [(j, c) for j in range(len(self.n_chunks)) for c in range(self.cin_p // 16)]

    def slice_offset(self, j: int, c: int) -> int:
        """Element offset of slice (N chunk j, 16-channel step c) in a
        phase's ``head_weight_layout``."""
        return (j * self.n_max * (self.cin_p // 16) + self.n_chunks[j][1] * c) * 144

    @property
    def in_hw(self) -> tuple[int, int]:
        return (self.h // 2, self.w // 2) if self.upsample else (self.h, self.w)

    @property
    def tiles_yx(self) -> tuple[int, int]:
        return -(-self.h // self.tile_h), -(-self.w // self.tile_w)

    @property
    def n_tiles(self) -> int:
        ty, tx = self.tiles_yx
        return self.batch * ty * tx

    @property
    def grid(self) -> int:
        return self.phases * min(self.n_tiles, self.n_sm // self.phases)

    def tile(self, t: int) -> tuple[int, int, int]:
        """(image, first row, first column) of tile t."""
        ty_n, tx_n = self.tiles_yx
        img, rem = divmod(t, ty_n * tx_n)
        ty, tx = divmod(rem, tx_n)
        return img, ty * self.tile_h, tx * self.tile_w

    def block_tiles(self, block: int) -> tuple[int, list[int]]:
        """(phase, tiles in walking order) of block ``block``."""
        return block % self.phases, list(range(block // self.phases, self.n_tiles,
                                               self.grid // self.phases))

    def items(self, block: int) -> list[tuple[int, int]]:
        """(tile, K chunk) of each input item block ``block`` copies, in
        order: one a tile where cin is one K chunk (its halo serves every N
        chunk), else one per (N chunk, K chunk)."""
        reps = 1 if len(self.k_chunks) == 1 else len(self.n_chunks)
        return [(t, k) for t in self.block_tiles(block)[1] for _ in range(reps)
                for k in range(len(self.k_chunks))]

    halo_shape = property(lambda self: (self.tile_h + 2, self.tile_w + 2))
    window_shape = property(lambda self: (self.tile_h // 2 + 2, self.tile_w // 2 + 2))

    def halo_origin(self, ty: int, tx: int) -> tuple[int, int]:
        return ty * self.tile_h - 1, tx * self.tile_w - 1

    def window_origin(self, ty: int, tx: int) -> tuple[int, int]:
        return ty * self.tile_h // 2 - 1, tx * self.tile_w // 2 - 1

    def _smem(self, ring: int) -> tuple[int, int]:
        """(bytes of a ring slot, shared memory bytes with ``ring`` slots):
        the ring, the input buffers (upsampling: the halo and two windows;
        else two halos), with a head the head rows (cols_p + 8 bf16 apart;
        the logits' staging, rows of cols_p + 2 bf16, over a halo) and the
        f32 bias and head bias, without one each warp's output staging (16
        pixels x (n_max + 8) bf16); an mbarrier a slot and two for the
        inputs; as the kernel lays them out."""
        planes = self.k_chunks[0][1] // 8
        slot = 288 * min(self.cout_p, self.n_max)
        hh, hw = self.halo_shape
        wh, ww = self.window_shape
        halo = hh * hw * 16 * planes
        if self.head:
            halo = max(halo, self.warps * self.rows * 16 * (self.cols_p + 2) * 2)
        inputs = halo + 2 * wh * ww * 16 * planes if self.upsample else 2 * halo
        if self.head:
            out = (self.cout_p * (self.cols_p + 8) * 2
                   + -(-(self.cout_p + self.cols_p) * 4 // 16) * 16)
        else:
            out = self.warps * 16 * (self.n_max + 8) * 2
        return slot, ring * slot + inputs + out + (ring + 2) * 8

    @property
    def ring(self) -> int:
        """Weight slots: every slice (resident) where they fit, else as many
        as fit, at most ``max_ring``."""
        slot, rest = self._smem(0)
        fit = min(self.max_ring, (SMEM_PER_BLOCK - rest) // (slot + 8))
        return self.slices if self.slices <= fit else fit

    @property
    def resident(self) -> bool:
        return self.slices <= self.ring

    @property
    def fits(self) -> bool:
        """Whether the shape takes this route: at most ``HEAD_COLS_MAX``
        head columns, a ring of 2 slots (or every slice) in shared memory,
        32-bit tile and item counts."""
        per = 1 if len(self.k_chunks) == 1 else len(self.n_chunks) * len(self.k_chunks)
        return (self.n_out <= HEAD_COLS_MAX and self.ring >= min(2, self.slices)
                and self.n_tiles * per < 2**31)

    @property
    def smem_bytes(self) -> int:
        return self._smem(self.ring)[1]

    def launch_args(self) -> tuple[int, ...]:
        """(tile_h, tile_w, K chunk width, ring slots, grid, shared memory
        bytes), as ``heads_wide_launch`` takes them; without a head, with
        ``n_max`` after the K chunk width, as ``conv_wide_launch`` does."""
        nm = () if self.head else (self.n_max,)
        return (self.tile_h, self.tile_w, self.k_chunks[0][1], *nm, self.ring, self.grid,
                self.smem_bytes)


def head_weight_layout(w: torch.Tensor, geo: HeadTiling) -> torch.Tensor:
    """The wide head kernel's weights: w (3, 3, cin, phases x cout) as
    (phases, slices): per phase its columns zero-padded to (3, 3, cin_p,
    cout_p), each N chunk's k-slices (16-channel step c, then tap, the
    channel's 8-channel half, the chunk's column, the channel within the
    half: wgmma's canonical K-major B) one after another, so that slice
    (j, c) starts at ``geo.slice_offset(j, c)``."""
    p = geo.phases
    wp = w.new_zeros((3, 3, geo.cin_p, p, geo.cout_p))
    wp[:, :, : geo.cin, :, : geo.cout] = w.reshape(3, 3, geo.cin, p, geo.cout)
    wp = wp.reshape(9, geo.cin_p // 16, 2, 8, p, geo.cout_p)
    return torch.cat([wp[..., n0 : n0 + nw].permute(4, 1, 0, 2, 5, 3).reshape(p, -1)
                      for n0, nw in geo.n_chunks], 1).contiguous()


def head_vectors(b, wh, bh, geo: HeadTiling):
    """The wide head kernel's bias (phases, cout_p) f32, head (phases,
    cout_p, cols_p + 8) bf16 and head bias (phases, cols_p) f32, zero past
    cout and n_out: phase p's head is block p of wh's diagonal (p rows of
    cout and columns of n_out; the whole head with one phase), so a
    block-diagonal head's other blocks are never read."""
    p, c, n = geo.phases, geo.cout, geo.n_out
    bias = torch.zeros((p, geo.cout_p), dtype=torch.float32, device=b.device)
    bias[:, :c] = b.float().reshape(p, c)
    head = torch.zeros((p, geo.cout_p, geo.cols_p + 8), dtype=_BF, device=wh.device)
    head[:, :c, :n] = wh.reshape(p, c, p, n).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    hb = torch.zeros((p, geo.cols_p), dtype=torch.float32, device=bh.device)
    hb[:, :n] = bh.float().reshape(p, n)
    return bias, head, hb


def wide_n_max(cout: int) -> int:
    """The N chunk width of K8's and K9's wide route (no head): 128 columns
    past 64 output channels, else 64. At full size (128 images of 128^2
    (K9) and 256^2 (K8), NVIDIA H100 80GB HBM3, 700.00 W,
    ``tools/final_wide_probe.py``) 128 took K9 6.09 / 8.57 / 29.05 ms at C
    = 96 / 128 / 256 against 64's 9.82 / 13.51 / 47.40 (16 images at 1152:
    65.1 / 111.7), K8 4.94 / 7.01 / 25.22 against 7.30 / 9.77 / 33.33; at
    C = 40 (one chunk of 48 either way) 64 took a 512-image batch 9.17 (K9)
    / 6.59 (K8) against 10.26 / 7.69."""
    return 128 if cout > 64 else 64


@dataclass(frozen=True)
class UpsampleTiling:
    """Launch geometry of the K9/K10 kernel (``csrc/upsample_conv.cu``) on a
    (batch, h, w, 64) half-resolution input: persistent blocks, one per SM,
    walk the tile_h x tile_w output tiles (image by image, tile rows, then
    tile columns), each with one halo and two window buffers (the next
    tile's window is copied while this one's products run). Tile (ty, tx)
    covers output rows ty * tile_h .. and upsamples a (tile_h + 2) x
    (tile_w + 2) halo, origin ``halo_origin``, from a (tile_h / 2 + 2) x
    (tile_w / 2 + 2) low-res window, origin ``window_origin``: the bilinear
    taps of the halo's rows oy0 - 1 .. oy0 + tile_h read low-res rows
    oy0/2 - 1 .. oy0/2 + tile_h/2 after the edge clamp. Window pixels
    outside the input are zero-filled and never read; halo pixels outside
    the output are zero (the conv's padding). The kernel is compiled for
    this tile and checks what it is given against its own layout."""

    tile_h: ClassVar[int] = 8
    tile_w: ClassVar[int] = 64

    batch: int
    h: int
    w: int
    head: bool = False  # K10: the head weights stay resident too
    n_sm: int = 132
    cin: int = UP_CHANNELS
    cout: int = UP_CHANNELS
    n_out: int = UP_HEAD_COLS  # K10's head columns

    def __post_init__(self):
        _check_final("final_heads" if self.head else "upsample_final", self.cin, self.cout,
                     self.n_out if self.head else None)

    @property
    def route(self) -> str:
        """"upsample_conv": this geometry's kernel; "wide": K9 at other
        widths, K10 at other widths or more than 16 head columns, up to
        ``HEAD_COLS_MAX``, on the wide kernel (``head_geo``); "any": K7's
        any route (``any_geo``), for K10 past the wide route.

        K9 takes the wide route at every width: it beat the any route at
        each one measured (NVIDIA H100 80GB HBM3, 700.00 W,
        ``tools/final_wide_probe.py``): a 512-image batch at C = 40 9.17
        ms against 42.01, 128 images of 128^2 at C = 96 / 128 / 256 6.09 /
        8.57 / 29.05 against 21.42 / 34.45 / 97.80, 16 at 1152 65.15
        against 170.30."""
        own = (self.cin == self.cout == UP_CHANNELS
               and (not self.head or self.n_out <= UP_HEAD_COLS))
        if own:
            return "upsample_conv"
        return "wide" if self.head_geo.fits else "any"

    @property
    def head_geo(self) -> HeadTiling:
        """The wide route's geometry (K9: no head, N chunks of
        ``wide_n_max``)."""
        n_out = self.n_out if self.head else 0
        return HeadTiling(self.batch, 2 * self.h, 2 * self.w, self.cin, self.cout, n_out,
                          upsample=True, n_sm=self.n_sm,
                          kernel="final_heads" if self.head else "upsample_final",
                          n_max=64 if self.head else wide_n_max(self.cout))

    @property
    def any_geo(self) -> DecoderConvTiling:
        return DecoderConvTiling(self.batch, 2 * self.h, 2 * self.w, self.cin, 0, self.cout,
                                 upsample=True, second_pass=self.head,
                                 kernel="final_heads" if self.head else "upsample_final")

    @property
    def out_hw(self) -> tuple[int, int]:
        return 2 * self.h, 2 * self.w

    @property
    def tiles_yx(self) -> tuple[int, int]:
        oh, ow = self.out_hw
        return -(-oh // self.tile_h), -(-ow // self.tile_w)

    @property
    def n_tiles(self) -> int:
        ty, tx = self.tiles_yx
        return self.batch * ty * tx

    @property
    def grid(self) -> int:
        return min(self.n_tiles, self.n_sm)

    @property
    def halo_shape(self) -> tuple[int, int]:
        return self.tile_h + 2, self.tile_w + 2

    @property
    def window_shape(self) -> tuple[int, int]:
        return self.tile_h // 2 + 2, self.tile_w // 2 + 2

    def halo_origin(self, ty: int, tx: int) -> tuple[int, int]:
        return ty * self.tile_h - 1, tx * self.tile_w - 1

    def window_origin(self, ty: int, tx: int) -> tuple[int, int]:
        return ty * self.tile_h // 2 - 1, tx * self.tile_w // 2 - 1

    @property
    def smem_bytes(self) -> int:
        """The resident weights, the halo, two windows (the output staging
        lies over the halo) and, for K10, the head weights (rows of 16 + 8
        bf16); the other routes': ``head_geo``'s or ``any_geo``'s."""
        if self.route != "upsample_conv":
            return (self.head_geo if self.route == "wide" else self.any_geo).smem_bytes
        (hh, hw), (wh, ww) = self.halo_shape, self.window_shape
        weights = 9 * UP_CHANNELS * UP_CHANNELS * 2
        halo_windows = (hh * hw + 2 * wh * ww) * UP_CHANNELS * 2
        head = UP_CHANNELS * (UP_HEAD_COLS + 8) * 2 if self.head else 0
        return weights + halo_windows + head

    def launch_args(self) -> tuple[int, int, int, int]:
        """(tile_h, tile_w, grid, shared memory bytes), as the launchers take them."""
        return self.tile_h, self.tile_w, self.grid, self.smem_bytes


@dataclass(frozen=True)
class StripTiling:
    """Launch geometry of the K8/K11 kernel (``csrc/conv64.cu``) on a
    (batch, h, w, 64) input: persistent blocks, one per SM, block b holding
    the weight of phase b % phases (K8: 1; K11: 4, one 64-channel conv per
    parity phase); each of a block's ``groups`` warpgroups is a worker of
    its own, worker (b // phases) * groups + g walking work items t = worker,
    += workers per phase. Item t is a strip of strip_h rows x strip_w
    columns of one image (images, then row segments, then column strips),
    walked downwards in steps of step_rows output rows, each reading input
    rows oy0 - 1 .. oy0 + step_rows and columns x0 - 1 .. x0 + strip_w. A
    worker's input rows form one stream (item after item, rows y0 - 1 ..
    y0 + step_rows * steps), position s held in slot s % ring of its ring;
    before a step's products the worker copies the stream up to the ring's
    free slots, after them the rest of the next step's rows
    (``worker_schedule`` states the order), by TMA. Input pixels outside
    the image are zero-filled (the conv's padding); output rows and columns
    past the image are not written. The kernel is compiled for this
    geometry and checks what it is given against its own."""

    strip_h: ClassVar[int] = 32
    strip_w: ClassVar[int] = 64
    step_rows: ClassVar[int] = 4
    ring: ClassVar[int] = 8
    groups: ClassVar[int] = 2

    batch: int
    h: int
    w: int
    phases: int = 1
    n_sm: int = 132
    cin: int = UP_CHANNELS
    cout: int = UP_CHANNELS  # per phase
    n_out: int = UP_HEAD_COLS  # K11's head columns per phase
    block_diagonal: bool = True  # K11: the caller states its head block-diagonal

    def __post_init__(self):
        k11 = self.phases > 1
        _check_final("composite_final_heads" if k11 else "final_conv_gelu", self.cin, self.cout,
                     self.n_out if k11 else None, self.phases)

    @property
    def route(self) -> str:
        """"conv64": this geometry's kernel; "wide": K8 at other widths where
        its weights stay resident in the wide kernel's ring (``head_geo``'s
        ``resident``), K11 at other widths, more than 16 head columns or with
        a head not stated block-diagonal, up to ``HEAD_COLS_MAX`` columns
        summed at once, on the wide kernel (``head_geo``); "any": K7's any
        route (``any_geo``), for K8 whose weights would stream (every SM
        copies each slice for each tile, where K7's any route shares them
        over a cluster) and K11 past the wide route (it multiplies all of
        the head).

        K8's rule rests on these times (full size: 128 images of 256^2, one
        call; NVIDIA H100 80GB HBM3, 700.00 W, ``tools/final_wide_probe.py``):
        C = 96 / 128 / 256, streamed on the wide route, 4.94 / 7.01 / 25.22
        ms against the any route's 3.01 / 6.53 / 24.37 (16 images at 1152:
        57.50 against 45.41); C = 40, resident (3 slices), a 512-image batch
        6.59 against 6.93."""
        own = self.cin == self.cout == UP_CHANNELS and (
            self.phases == 1 or (self.n_out <= UP_HEAD_COLS and self.block_diagonal))
        if own:
            return "conv64"
        geo = self.head_geo
        return "wide" if geo.fits and (self.phases > 1 or geo.resident) else "any"

    @property
    def head_geo(self) -> HeadTiling:
        """The wide route's geometry. K8: one phase, no head, N chunks of
        ``wide_n_max``. K11: a head stated block-diagonal as four phases of
        (cout, n_out), each block reading only its diagonal head block; any
        other as one phase of (4 cout, 4 n_out)."""
        if self.phases == 1:
            return HeadTiling(self.batch, self.h, self.w, self.cin, self.cout, 0, n_sm=self.n_sm,
                              kernel="final_conv_gelu", n_max=wide_n_max(self.cout))
        k = 1 if self.block_diagonal else self.phases
        return HeadTiling(self.batch, self.h, self.w, self.cin, k * self.cout, k * self.n_out,
                          phases=self.phases // k, n_sm=self.n_sm,
                          kernel="composite_final_heads")

    @property
    def any_geo(self) -> DecoderConvTiling:
        k11 = self.phases > 1
        return DecoderConvTiling(self.batch, self.h, self.w, self.cin, 0, self.phases * self.cout,
                                 second_pass=k11,
                                 kernel="composite_final_heads" if k11 else "final_conv_gelu")

    @property
    def strips_yx(self) -> tuple[int, int]:
        return -(-self.h // self.strip_h), -(-self.w // self.strip_w)

    @property
    def n_items(self) -> int:
        sy, sx = self.strips_yx
        return self.batch * sy * sx

    @property
    def grid(self) -> int:
        return self.phases * min(-(-self.n_items // self.groups), self.n_sm // self.phases)

    def item(self, t: int) -> tuple[int, int, int, int]:
        """(image, first row, first column, steps) of work item t."""
        sy_n, sx_n = self.strips_yx
        img, rem = divmod(t, sy_n * sx_n)
        sy, sx = divmod(rem, sx_n)
        y0 = sy * self.strip_h
        return img, y0, sx * self.strip_w, -(-min(self.strip_h, self.h - y0) // self.step_rows)

    def worker_schedule(self, block: int, group: int):
        """The kernel's order of work in warpgroup ``group`` of ``block``:
        ("copy", position, image, input row, x0) as each row's copy is
        issued and ("step", position of its first input row, image, first
        output row, x0) where a step's products read the ring (every copy
        issued before it has landed by then)."""
        stride = self.grid // self.phases * self.groups
        first = block // self.phases * self.groups + group
        win = self.step_rows + 2
        items = range(first, self.n_items, stride)
        rows = ((t, k) for t in items for k in range(self.step_rows * self.item(t)[3] + 2))
        pos = 0

        def issue_until(limit):
            nonlocal pos
            while pos < limit:
                nxt = next(rows, None)
                if nxt is None:
                    return
                img, y0, x0, _ = self.item(nxt[0])
                yield "copy", pos, img, y0 - 1 + nxt[1], x0
                pos += 1

        yield from issue_until(win)
        p = 0
        for t in items:
            img, y0, x0, steps = self.item(t)
            for j in range(steps):
                yield from issue_until(p + self.ring)
                yield "step", p, img, y0 + j * self.step_rows, x0
                p_next = p + (win if j + 1 == steps else self.step_rows)
                yield from issue_until(p_next + win)
                p = p_next

    @property
    def smem_bytes(self) -> int:
        """The resident weights, a ring of planar input rows per worker, a
        staging row of 16 output pixels (64 + 8 bf16 each) per warp, an
        mbarrier per ring slot and, for K11, the head weights (rows of
        16 + 8 bf16); the other routes': ``head_geo``'s or ``any_geo``'s."""
        if self.route != "conv64":
            return (self.head_geo if self.route == "wide" else self.any_geo).smem_bytes
        weights = 9 * UP_CHANNELS * UP_CHANNELS * 2
        rings = self.groups * self.ring * (self.strip_w + 2) * UP_CHANNELS * 2
        staging = 8 * 16 * (UP_CHANNELS + 8) * 2
        barriers = self.groups * self.ring * 8
        head = UP_CHANNELS * (UP_HEAD_COLS + 8) * 2 if self.phases > 1 else 0
        return weights + rings + staging + barriers + head

    def launch_args(self) -> tuple[int, int, int, int, int, int]:
        """(strip_h, strip_w, step_rows, ring, grid, shared memory bytes),
        as the launchers take them."""
        return (self.strip_h, self.strip_w, self.step_rows, self.ring, self.grid,
                self.smem_bytes)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, 2H, 2W, C), nearest."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _up_axis(v: torch.Tensor, axis: int, dtype: torch.dtype) -> torch.Tensor:
    """2x along ``axis`` of f32 ``v``, each output rounded once to ``dtype``:
    even[i] = 0.25 v[i-1] + 0.75 v[i], odd[i] = 0.75 v[i] + 0.25 v[i+1],
    edges clamped (the products in f32, their sum in f32, then the cast)."""
    n = v.shape[axis]
    q, t = 0.25 * v, 0.75 * v
    shape = list(v.shape)
    shape.insert(axis + 1, 2)
    out = torch.empty(shape, dtype=dtype, device=v.device)
    even, odd = out.select(axis + 1, 0), out.select(axis + 1, 1)
    torch.add(q.narrow(axis, 0, n - 1), t.narrow(axis, 1, n - 1), out=even.narrow(axis, 1, n - 1))
    torch.add(q.narrow(axis, 0, 1), t.narrow(axis, 0, 1), out=even.narrow(axis, 0, 1))
    torch.add(t.narrow(axis, 0, n - 1), q.narrow(axis, 1, n - 1), out=odd.narrow(axis, 0, n - 1))
    torch.add(t.narrow(axis, n - 1, 1), q.narrow(axis, n - 1, 1), out=odd.narrow(axis, n - 1, 1))
    return out.flatten(axis, axis + 1)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, 2H, 2W, C), bilinear with half-pixel centres and
    edge clamp, computed in f32 (rows, then columns) and cast back:
    out[2i] = 0.25 in[i-1] + 0.75 in[i], out[2i+1] = 0.75 in[i] + 0.25 in[i+1]."""
    return _up_axis(_up_axis(x.float(), 1, torch.float32), 2, x.dtype)


def _f(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, held in f32."""
    return t.to(_BF).float()


def _conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv, f32: x (B, H, W, Ci), w (3, 3, Ci, Co) → (B, H, W, Co)."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


@cuda.exact_f32()
def conv_epilogue_plain(acc, c, exact_gelu: bool = False, ln=(None, None), head=(None, None)):
    """The conv's epilogue: acc (..., ld) f32 conv + bias → its first c
    values through the LayerNorm ``ln`` (scale, bias), GELU, and with a
    head (wh (c, nh), bh) the GELU output rounded to bf16 through it; bf16.
    The plain twin of the any route's second pass (``conv_epilogue_launch``)
    and the tail of every plain version below."""
    acc = acc[..., :c]
    if ln[0] is not None:
        mu = acc.mean(-1, keepdim=True)
        var = (acc - mu).square().mean(-1, keepdim=True)
        acc = (acc - mu) * torch.rsqrt(var + 1e-6) * _f(ln[0]) + _f(ln[1])
    y = gelu_kernel(acc, exact_gelu)
    if head[0] is None:
        return y.to(_BF)
    return (_f(y) @ _f(head[0]) + _f(head[1])).to(_BF)


@cuda.exact_f32()
def decoder_conv_plain(x, skip, w, b, ln_scale=None, ln_bias=None, exact_gelu: bool = False):
    xin = _f(x) if skip is None else torch.cat([_f(x), _f(skip)], dim=-1)
    return conv_epilogue_plain(_conv3x3(xin, _f(w)) + _f(b), w.shape[-1], exact_gelu,
                               (ln_scale, ln_bias))


@cuda.exact_f32()
def final_conv_gelu_plain(x, w, b, exact_gelu: bool = False):
    return conv_epilogue_plain(_conv3x3(_f(x), _f(w)) + _f(b), w.shape[-1], exact_gelu)


def upsample_final_plain(x, w, b, exact_gelu: bool = False):
    return final_conv_gelu_plain(upsample2x_bilinear(x.to(_BF)), w, b, exact_gelu)


@cuda.exact_f32()
def final_heads_plain(x, w, b, wh, bh, exact_gelu: bool = False):
    up = upsample2x_bilinear(x.to(_BF)).float()
    return conv_epilogue_plain(_conv3x3(up, _f(w)) + _f(b), w.shape[-1], exact_gelu,
                               head=(wh, bh))


@cuda.exact_f32()
def composite_final_heads_plain(x, wc, bias4, wh_bd, bh4, exact_gelu: bool = False):
    return conv_epilogue_plain(_conv3x3(_f(x), _f(wc)) + _f(bias4), wc.shape[-1], exact_gelu,
                               head=(wh_bd, bh4))


@cuda.exact_f32()
def composite_final_heads_by_phase(x, wc, bias4, wh_bd, bh4, exact_gelu: bool = False,
                                   head_of=None):
    """K11's kernel decomposition, plain: parity phase p as a conv cin →
    cout with wc[..., p cout : (p + 1) cout] and its bias slice, GELU rounded
    to bf16, through diagonal head block ``head_of[p]`` of wh_bd (the
    identity by default) and its bias slice; the phases' logits side by
    side. Equals ``composite_final_heads_plain`` for a block-diagonal wh_bd
    up to the order of the f32 head sums."""
    c4, n4 = wh_bd.shape
    c, n = c4 // K11_PHASES, n4 // K11_PHASES
    outs = []
    for p, hp in enumerate(head_of or range(K11_PHASES)):
        y = gelu_kernel(_conv3x3(_f(x), _f(wc[..., p * c : (p + 1) * c]))
                        + _f(bias4[p * c : (p + 1) * c]), exact_gelu)
        outs.append(_f(y) @ _f(wh_bd[hp * c : (hp + 1) * c, hp * n : (hp + 1) * n])
                    + _f(bh4[hp * n : (hp + 1) * n]))
    return torch.cat(outs, -1).to(_BF)


def _act(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(_BF).contiguous()


def _check_final(name: str, cin: int, cout: int, n_out: int | None, phases: int = 1) -> None:
    """K8-K11's widths: cin, cout >= 1 (per phase, K11); with a head at
    least one column and a conv output (over K11's phases) of at most
    ``HEAD_MAX_WIDTH`` channels."""
    head = n_out is not None
    if min(cin, cout) <= 0 or (head and (n_out <= 0 or phases * cout > HEAD_MAX_WIDTH)):
        raise ValueError(f"{name} kernel takes cin, cout >= 1 and, with a head, n_out >= 1 and "
                         f"{phases} x cout <= {HEAD_MAX_WIDTH} (HEAD_MAX_WIDTH), got cin {cin}, "
                         f"cout {cout}, n_out {n_out}")


@functools.cache
def _k7_slots(n_tile: int, any_route: bool, device: torch.device) -> int:
    """Blocks of K7's kernel of tile width ``n_tile`` (its fixed route's or
    its any route's instantiation) that fit the card at once, in whole
    clusters (the kernel's own occupancy query)."""
    n = cuda.size_query("decoder_conv", "decoder_conv_slots", device, n_tile, int(any_route))
    if n <= 0:
        raise RuntimeError(f"decoder_conv: no cluster of the {n_tile}-wide kernel fits the card")
    return n


def _k7_geometry(geo: DecoderConvTiling, device: torch.device) -> DecoderConvTiling:
    """``geo`` with the slots of the instantiation it runs on."""
    return dataclasses.replace(geo, slots=_k7_slots(geo.n_tile, geo.route == "any", device))


def _padded(v: torch.Tensor | None, n: int) -> torch.Tensor | None:
    """A (c,) vector zero-padded to (n,), bf16 (the any route's padded
    output columns take zero bias and LayerNorm vectors)."""
    if v is None:
        return None
    out = torch.zeros(n, dtype=_BF, device=v.device)
    out[: v.shape[0]] = v
    return out


# K7's any route for each wrapper that runs it (one a column chunk) and its
# second pass
ANY_LAUNCHES = {n: cuda.LaunchCount() for n in ("decoder_conv", "final_conv_gelu",
                                                "upsample_final", "final_heads",
                                                "composite_final_heads")}
EPILOGUE_LAUNCHES = cuda.LaunchCount()


# the wide kernel, per wrapper that runs it (one a call)
WIDE_LAUNCHES = {n: cuda.LaunchCount() for n in ("final_conv_gelu", "upsample_final",
                                                 "final_heads", "composite_final_heads")}


def _heads_wide(geo: HeadTiling, x, w, b, wh, bh, exact_gelu) -> torch.Tensor:
    """The wide head kernel (``csrc/final_heads_wide.cu``) for
    ``geo.kernel``'s wrapper on checked bf16, contiguous CUDA tensors: one
    launch, the weights and vectors laid out as it reads them
    (``head_weight_layout``, ``head_vectors``); logits (batch, h, w, phases
    x n_out) bf16."""
    wl = head_weight_layout(w, geo)
    bias, head, hb = head_vectors(b, wh, bh, geo)
    out = torch.empty((geo.batch, geo.h, geo.w, geo.phases * geo.n_out), dtype=_BF,
                      device=x.device)
    in_h, in_w = geo.in_hw
    cuda.launch("final_heads_wide", "heads_wide_launch", cuda.ptr(x), cuda.ptr(wl),
                cuda.ptr(bias), cuda.ptr(head), cuda.ptr(hb), cuda.ptr(out), geo.batch, in_h,
                in_w, geo.cin, geo.cout_p, geo.cols_p, geo.n_out, geo.phases, int(geo.upsample),
                int(exact_gelu), *geo.launch_args(), cuda.stream(x))
    WIDE_LAUNCHES[geo.kernel].launches += 1
    return out


def _conv_wide(geo: HeadTiling, x, w, b, exact_gelu) -> torch.Tensor:
    """The wide kernel with no head (``conv_wide_launch``) for K8 or K9
    (``geo.kernel``) on checked bf16, contiguous CUDA tensors: one launch,
    the weight laid out as it reads it (``head_weight_layout``), the bias
    f32 zero-padded to ``cout_p``; (batch, h, w, cout) bf16."""
    wl = head_weight_layout(w, geo)
    bias = torch.zeros(geo.cout_p, dtype=torch.float32, device=b.device)
    bias[: geo.cout] = b.float()
    out = torch.empty((geo.batch, geo.h, geo.w, geo.cout), dtype=_BF, device=x.device)
    in_h, in_w = geo.in_hw
    cuda.launch("final_heads_wide", "conv_wide_launch", cuda.ptr(x), cuda.ptr(wl),
                cuda.ptr(bias), cuda.ptr(out), geo.batch, in_h, in_w, geo.cin, geo.cout_p,
                geo.cout, int(geo.upsample), int(exact_gelu), *geo.launch_args(),
                cuda.stream(x))
    WIDE_LAUNCHES[geo.kernel].launches += 1
    return out


def _epilogue(acc, c, out, exact_gelu, ln=(None, None), head=(None, None)) -> None:
    """The any route's second pass (``conv_epilogue_launch``): acc (..., ld)
    f32 → LayerNorm over its first c values (``ln``), GELU, bf16, through
    ``head`` (wh (c, nh), bh) when given, into out; ``conv_epilogue_plain``
    is its plain twin."""
    ld = acc.shape[-1]
    n_pix = acc.numel() // ld
    if n_pix >= 2**31:
        raise ValueError(f"conv_epilogue takes fewer than 2^31 pixels, got {n_pix}")
    wh, bh = head
    pix = 8 if wh is None else min(64, max(8, 96 * 1024 // (2 * c) // 8 * 8),
                                    SMEM_PER_BLOCK // (2 * c))
    smem = 0 if wh is None else pix * c * 2
    grid = min(-(-n_pix // pix), 8 * cuda.sm_count(acc.device))
    cuda.launch("decoder_conv", "conv_epilogue_launch", cuda.ptr(acc), ld, n_pix, c,
                cuda.ptr(ln[0]), cuda.ptr(ln[1]), cuda.ptr(wh), cuda.ptr(bh),
                0 if wh is None else wh.shape[-1], cuda.ptr(out), int(exact_gelu), pix, grid,
                smem, cuda.stream(acc))
    EPILOGUE_LAUNCHES.launches += 1


def _conv_any(geo: DecoderConvTiling, x, skip, w, b, ln=(None, None), exact_gelu=False,
              head=(None, None), n_out=None) -> torch.Tensor:
    """K7's any route for ``geo.kernel``'s wrapper, on checked bf16,
    contiguous CUDA tensors: one launch per column chunk at tile width
    ``geo.n_tile``, the weights and vectors zero-padded; where ``geo.raw``,
    f32 conv + bias into a scratch, then ``_epilogue`` (LayerNorm ``ln``,
    GELU and ``head``)."""
    geo = _k7_geometry(geo, x.device)
    wl = k7_weight_layout_any(w, geo)
    npad = geo.n_chunks * geo.n_tile
    bp = _padded(b, npad)
    modes = [SRC_MODES[m] for m in geo.source_modes()]
    in_h, in_w = geo.in_hw
    out = torch.empty((geo.batch, geo.h, geo.w, n_out or geo.cout), dtype=_BF, device=x.device)
    raw = (torch.empty((geo.batch, geo.h, geo.w, npad), dtype=torch.float32, device=x.device)
           if geo.raw else None)
    lp = (None, None) if raw is not None else tuple(_padded(v, npad) for v in ln)
    for j in range(geo.n_chunks):
        n0 = j * geo.n_tile
        cuda.launch(
            "decoder_conv", "decoder_conv_any_launch", cuda.ptr(x), cuda.ptr(skip),
            cuda.ptr(wl[j]), cuda.ptr(bp[n0:]), cuda.ptr(lp[0]), cuda.ptr(lp[1]),
            cuda.ptr(None if raw is not None else out),
            cuda.ptr(None if raw is None else raw[..., n0:]), npad, geo.batch, geo.h, geo.w,
            geo.cx, geo.cs, min(geo.cout, geo.n_tile), geo.n_tile, *modes, in_h, in_w,
            int(exact_gelu), *geo.launch_args(), cuda.stream(x),
        )
        ANY_LAUNCHES[geo.kernel].launches += 1
    if raw is not None:
        _epilogue(raw, geo.cout, out, exact_gelu, ln, head)
    return out


def decoder_conv(x, skip, w, b, ln_scale=None, ln_bias=None, exact_gelu: bool = False):
    """One decoder conv step: x (B, H, W, cx) at the output resolution,
    skip (B, H, W, cs) or None, w (3, 3, cx + cs, cout), b and the optional
    LayerNorm vectors (cout,) → (B, H, W, cout) bf16. The kernel takes the
    weights bf16 and contiguous (``HoverNeXt.fuse``) and raises on anything
    else; it reads them laid out by ``k7_weight_layout`` (one copy per
    call), the skip's rows at an offset of cx. Shapes its compiled widths
    do not take run its any route (``_conv_any``)."""
    if not x.is_cuda:
        return decoder_conv_plain(x, skip, w, b, ln_scale, ln_bias, exact_gelu)
    bsz, h, wd, cx = x.shape
    cs = 0 if skip is None else skip.shape[-1]
    cout = w.shape[-1]
    geo = DecoderConvTiling(bsz, h, wd, cx, cs, cout)
    xb, sb = _act(x), _act(skip)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cx))
    if sb is not None:
        cuda.check(sb, "skip", _BF, (bsz, h, wd, cs))
    cuda.check(w, "w", _BF, (3, 3, cx + cs, cout))
    cuda.check(b, "b", _BF, (cout,))
    if ln_scale is not None:
        cuda.check(ln_scale, "ln_scale", _BF, (cout,))
        cuda.check(ln_bias, "ln_bias", _BF, (cout,))
    if geo.route == "any":
        return _conv_any(geo, xb, sb, w, b, (ln_scale, ln_bias), exact_gelu)
    out = torch.empty((bsz, h, wd, cout), dtype=_BF, device=x.device)
    geo = _k7_geometry(geo, x.device)
    wl = k7_weight_layout(w)
    cuda.launch(
        "decoder_conv", "decoder_conv_launch", cuda.ptr(xb), cuda.ptr(sb), cuda.ptr(wl),
        cuda.ptr(b), cuda.ptr(ln_scale), cuda.ptr(ln_bias), cuda.ptr(out),
        bsz, h, wd, cx, cs, cout, int(exact_gelu), *geo.launch_args(), cuda.stream(xb),
    )
    decoder_conv.launches += 1
    return out


def final_conv_gelu(x, w, b, exact_gelu: bool = False):
    """Full-resolution 3x3 conv + bias + GELU: x (B, H, W, cin), w (3, 3,
    cin, cout) → (B, H, W, cout) bf16. H must be a multiple of 32, on both
    devices, as the TPU kernel requires at its default ``rows=32``; any W
    and batch: offsets are 64-bit, so one call takes a TTA x4 batch of 128
    tiles (2^31 elements). Its kernel takes cin = cout = 64; other widths
    run the wide kernel with no head (``_conv_wide``)."""
    bsz, h, wd, cin = x.shape
    if h % FINAL_CONV_ROWS:
        raise ValueError(f"H={h} must be a multiple of rows={FINAL_CONV_ROWS}")
    if not x.is_cuda:
        return final_conv_gelu_plain(x, w, b, exact_gelu)
    cout = w.shape[-1]
    geo = StripTiling(bsz, h, wd, n_sm=cuda.sm_count(x.device), cin=cin, cout=cout)
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(w, "w", _BF, (3, 3, cin, cout))
    cuda.check(b, "b", _BF, (cout,))
    if geo.route == "wide":
        return _conv_wide(geo.head_geo, xb, w, b, exact_gelu)
    if geo.route == "any":
        return _conv_any(geo.any_geo, xb, None, w, b, exact_gelu=exact_gelu)
    out = torch.empty((bsz, h, wd, cout), dtype=_BF, device=x.device)
    cuda.launch(
        "conv64", "final_conv_gelu_launch", cuda.ptr(xb), cuda.ptr(w), cuda.ptr(b),
        cuda.ptr(out), bsz, h, wd, cin, cout, int(exact_gelu), *geo.launch_args(),
        cuda.stream(xb),
    )
    final_conv_gelu.launches += 1
    return out


def upsample_final(x, w, b, exact_gelu: bool = False):
    """x (B, H, W, cin) → bilinear 2x → 3x3 conv (w, b) → GELU → (B, 2H,
    2W, cout) bf16. The kernel upsamples each output tile's halo once into
    shared memory; it takes cin = cout = 64, other widths run the wide
    kernel with no head (``_conv_wide``: the whole block upsamples each
    tile's halo from a window TMA lands). 2H must be a multiple of 4, as
    the TPU kernel requires (it writes the output in 4 row chunks)."""
    bsz, h, wd, cin = x.shape
    if (2 * h) % 4:
        raise ValueError(f"2*H must be a multiple of 4, got H={h}")
    if not x.is_cuda:
        return upsample_final_plain(x, w, b, exact_gelu)
    cout = w.shape[-1]
    geo = UpsampleTiling(bsz, h, wd, n_sm=cuda.sm_count(x.device), cin=cin, cout=cout)
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(w, "w", _BF, (3, 3, cin, cout))
    cuda.check(b, "b", _BF, (cout,))
    if geo.route == "wide":
        return _conv_wide(geo.head_geo, xb, w, b, exact_gelu)
    if geo.route == "any":
        return _conv_any(geo.any_geo, xb, None, w, b, exact_gelu=exact_gelu)
    out = torch.empty((bsz, 2 * h, 2 * wd, cout), dtype=_BF, device=x.device)
    cuda.launch(
        "upsample_conv", "upsample_final_launch", cuda.ptr(xb), cuda.ptr(w), cuda.ptr(b),
        cuda.ptr(out), bsz, h, wd, cin, cout, int(exact_gelu), *geo.launch_args(),
        cuda.stream(xb),
    )
    upsample_final.launches += 1
    return out


def final_heads(x, w, b, wh, bh, exact_gelu: bool = False):
    """x (B, H, W, cin) → bilinear 2x → 3x3 conv (w, b) → GELU → head
    product (wh (cout, n_out), bh) → logits (B, 2H, 2W, n_out) bf16, NHWC.
    The kernel (K9's, with the head product in its epilogue) takes cin =
    cout = 64 and n_out <= 16; other widths and heads of up to
    ``HEAD_COLS_MAX`` columns run the wide head kernel (``_heads_wide``:
    the head on the tensor cores in the conv's epilogue), wider heads K7's
    any route (conv + bias in f32, then GELU and the head in its second
    pass). 2H must be a multiple of 4, on both devices, as the TPU kernel
    requires (it writes the output in 4 row chunks)."""
    bsz, h, wd, cin = x.shape
    if (2 * h) % 4:
        raise ValueError(f"2*H must be a multiple of 4, got H={h}")
    if not x.is_cuda:
        return final_heads_plain(x, w, b, wh, bh, exact_gelu)
    cout, n_out = w.shape[-1], wh.shape[-1]
    geo = UpsampleTiling(bsz, h, wd, head=True, n_sm=cuda.sm_count(x.device), cin=cin,
                         cout=cout, n_out=n_out)
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(w, "w", _BF, (3, 3, cin, cout))
    cuda.check(b, "b", _BF, (cout,))
    cuda.check(wh, "wh", _BF, (cout, n_out))
    cuda.check(bh, "bh", _BF, (n_out,))
    if geo.route == "wide":
        return _heads_wide(geo.head_geo, xb, w, b, wh, bh, exact_gelu)
    if geo.route == "any":
        return _conv_any(geo.any_geo, xb, None, w, b, exact_gelu=exact_gelu, head=(wh, bh),
                         n_out=n_out)
    out = torch.empty((bsz, 2 * h, 2 * wd, n_out), dtype=_BF, device=x.device)
    cuda.launch(
        "upsample_conv", "final_heads_launch", cuda.ptr(xb), cuda.ptr(w), cuda.ptr(b),
        cuda.ptr(wh), cuda.ptr(bh), cuda.ptr(out), bsz, h, wd, cin, cout, n_out,
        int(exact_gelu), *geo.launch_args(), cuda.stream(xb),
    )
    final_heads.launches += 1
    return out


def composite_final_heads(x, wc, bias4, wh_bd, bh4, exact_gelu: bool = False,
                          block_diagonal: bool = False):
    """The final stage in the low-res parity domain: x (B, H, W, cin), wc
    (3, 3, cin, 4 cout) parity-folded weights, bias4 (4 cout,), wh_bd
    (4 cout, 4 n_out) heads, bh4 (4 n_out,) → (B, H, W, 4 n_out) bf16
    parity logits, phase-major (a, b) = 00, 01, 10, 11.

    The TPU kernel multiplies the whole of wh_bd, which its caller builds
    block-diagonal (the head repeated per phase,
    ``hovernext_fn._block_diag_heads``), as the plain version does.
    ``block_diagonal=True`` states that wh_bd is so, as
    ``hovernext_fn.k11_weights`` builds it: then, at cin = cout = 64 and
    n_out <= 16, the kernel runs each phase as a conv cin → cout with its
    diagonal head block and reads no other block, and at other widths and
    up to ``HEAD_COLS_MAX`` columns so does the wide head kernel
    (``_heads_wide``). Without it the wide head kernel runs the conv cin →
    4 cout and multiplies the whole head, its four phases' sums kept on
    chip (up to ``HEAD_COLS_MAX`` columns in all); past that, K7's any
    route: the conv in f32, then GELU and the whole head product in its
    second pass. Nothing waits for the device."""
    if not x.is_cuda:
        return composite_final_heads_plain(x, wc, bias4, wh_bd, bh4, exact_gelu)
    bsz, h, wd, cin = x.shape
    c4, n4 = wc.shape[-1], wh_bd.shape[-1]
    if c4 % K11_PHASES or n4 % K11_PHASES:
        raise ValueError(f"composite_final_heads kernel takes c4 = {K11_PHASES} x cout and "
                         f"n4 = {K11_PHASES} x n_out, got {c4}, {n4}")
    geo = StripTiling(bsz, h, wd, phases=K11_PHASES, n_sm=cuda.sm_count(x.device), cin=cin,
                      cout=c4 // K11_PHASES, n_out=n4 // K11_PHASES,
                      block_diagonal=block_diagonal)
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(wc, "wc", _BF, (3, 3, cin, c4))
    cuda.check(bias4, "bias4", _BF, (c4,))
    cuda.check(wh_bd, "wh_bd", _BF, (c4, n4))
    cuda.check(bh4, "bh4", _BF, (n4,))
    if geo.route == "wide":
        return _heads_wide(geo.head_geo, xb, wc, bias4, wh_bd, bh4, exact_gelu)
    if geo.route == "any":
        return _conv_any(geo.any_geo, xb, None, wc, bias4, exact_gelu=exact_gelu,
                         head=(wh_bd, bh4), n_out=n4)
    out = torch.empty((bsz, h, wd, n4), dtype=_BF, device=x.device)
    cuda.launch(
        "conv64", "composite_final_heads_launch", cuda.ptr(xb), cuda.ptr(wc),
        cuda.ptr(bias4), cuda.ptr(wh_bd), cuda.ptr(bh4), cuda.ptr(out), bsz, h, wd, cin, c4, n4,
        int(exact_gelu), *geo.launch_args(), cuda.stream(xb),
    )
    composite_final_heads.launches += 1
    return out


decoder_conv.launches = 0
final_conv_gelu.launches = 0
upsample_final.launches = 0
final_heads.launches = 0
composite_final_heads.launches = 0
