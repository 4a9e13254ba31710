"""K7-K11: the HoverNeXt decoder and final-stage kernels.

Counterpart of the JAX package's ``ops/pallas/decoder.py``. Each wrapper
launches its hand-written kernel (K7: ``csrc/decoder_conv.cu``; K9, K10:
``csrc/upsample_conv.cu``; K8, K11: ``csrc/conv64.cu``; the last two share
the 64-channel conv core ``csrc/conv64.cuh``) on a CUDA tensor and runs its
``*_plain`` twin on a CPU tensor:

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
  parity-folded weights + bias + GELU + block-diagonal head product; the
  kernel runs each parity phase as its own 64-channel conv with its
  diagonal head block (``StripTiling`` with four phases).

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
UP_CHANNELS = 64  # K8-K11 kernels: cin = cout (per phase, K11)
UP_HEAD_COLS = 16  # K10/K11 kernels: head columns (per phase, K11), zero-padded
K11_PHASES = 4  # the parity phases of K11's composite weights
FINAL_CONV_ROWS = 32  # K8: the TPU kernel's default strip (H % rows == 0)
SMEM_PER_BLOCK = cuda.SMEM_PER_BLOCK


def k7_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """K7's weight (3, 3, K, cout) as the kernel reads it: (K / 32, 9, 4,
    cout, 8), chunk c of 32 input channels, tap dy * 3 + dx, 8-channel plane,
    output channel, channel within the plane (wgmma's canonical K-major B),
    so that the k-slice of (chunk, taps) is contiguous. The skip's rows (K
    from cx on) follow x's as they do in w."""
    k, cout = w.shape[2], w.shape[3]
    return (w.reshape(9, k // CIN_MULTIPLE, 4, 8, cout).permute(1, 0, 2, 4, 3)
            .contiguous())


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
    against its own."""

    k_chunk: ClassVar[int] = CIN_MULTIPLE
    cluster: ClassVar[int] = 2  # clusters of 4 ran slower: fewer of them fit the card at once

    batch: int
    h: int
    w: int
    cx: int
    cs: int
    cout: int
    slots: int = 132

    def __post_init__(self):
        _check_conv([self.cx] + ([self.cs] if self.cs else []), self.cout, "decoder_conv")

    @property
    def _geo(self) -> tuple[int, ...]:
        return _K7_GEOMETRY[self.cout]

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
        return self.cout // self.split

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
        """32-channel chunks of x and of the skip."""
        return self.cx // self.k_chunk, self.cs // self.k_chunk

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
        skip), first channel in the source, first weight row of K, taps)."""
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
        return self.taps * self.k_chunk * self.cout * 2

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
        weights = 9 * (self.cx + self.cs) * self.cout * 2
        return {"weights": self.groups * weights,
                "activations": self.groups * self.cluster * (nx + ns) * self.halo_bytes}

    def launch_args(self) -> tuple[int, ...]:
        """(tile_h, tile_w, taps, ring_w, ring_h, cluster, grid, shared
        memory bytes), as the launcher takes them."""
        return (self.tile_h, self.tile_w, self.taps, self.ring_w, self.ring_h, self.cluster,
                self.grid, self.smem_bytes)


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
        bf16)."""
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
        16 + 8 bf16)."""
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
def decoder_conv_plain(x, skip, w, b, ln_scale=None, ln_bias=None, exact_gelu: bool = False):
    xin = _f(x) if skip is None else torch.cat([_f(x), _f(skip)], dim=-1)
    acc = _conv3x3(xin, _f(w)) + _f(b)
    if ln_scale is not None:
        mu = acc.mean(-1, keepdim=True)
        var = (acc - mu).square().mean(-1, keepdim=True)
        acc = (acc - mu) * torch.rsqrt(var + 1e-6) * _f(ln_scale) + _f(ln_bias)
    return gelu_kernel(acc, exact_gelu).to(_BF)


@cuda.exact_f32()
def final_conv_gelu_plain(x, w, b, exact_gelu: bool = False):
    return gelu_kernel(_conv3x3(_f(x), _f(w)) + _f(b), exact_gelu).to(_BF)


def upsample_final_plain(x, w, b, exact_gelu: bool = False):
    return final_conv_gelu_plain(upsample2x_bilinear(x.to(_BF)), w, b, exact_gelu)


@cuda.exact_f32()
def final_heads_plain(x, w, b, wh, bh, exact_gelu: bool = False):
    up = upsample2x_bilinear(x.to(_BF)).float()
    y = gelu_kernel(_conv3x3(up, _f(w)) + _f(b), exact_gelu)
    return (_f(y) @ _f(wh) + _f(bh)).to(_BF)


@cuda.exact_f32()
def composite_final_heads_plain(x, wc, bias4, wh_bd, bh4, exact_gelu: bool = False):
    y = gelu_kernel(_conv3x3(_f(x), _f(wc)) + _f(bias4), exact_gelu)
    return (_f(y) @ _f(wh_bd) + _f(bh4)).to(_BF)


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


def _check_conv(cins: list[int], cout: int, name: str) -> None:
    if cout not in KERNEL_COUTS or any(c <= 0 or c % CIN_MULTIPLE for c in cins):
        raise ValueError(f"{name} kernel takes cout in {KERNEL_COUTS} and input channels that "
                         f"are multiples of {CIN_MULTIPLE}, got cin {cins}, cout {cout}")


def decoder_conv(x, skip, w, b, ln_scale=None, ln_bias=None, exact_gelu: bool = False):
    """One decoder conv step: x (B, H, W, cx) at the output resolution,
    skip (B, H, W, cs) or None, w (3, 3, cx + cs, cout), b and the optional
    LayerNorm vectors (cout,) → (B, H, W, cout) bf16. The kernel takes the
    weights bf16 and contiguous (``HoverNeXt.fuse``) and raises on anything
    else; it reads them laid out by ``k7_weight_layout`` (one copy per
    call), the skip's rows at an offset of cx."""
    if not x.is_cuda:
        return decoder_conv_plain(x, skip, w, b, ln_scale, ln_bias, exact_gelu)
    bsz, h, wd, cx = x.shape
    cs = 0 if skip is None else skip.shape[-1]
    cout = w.shape[-1]
    _check_conv([cx] + ([cs] if cs else []), cout, "decoder_conv")
    xb, sb = _act(x), _act(skip)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cx))
    if sb is not None:
        cuda.check(sb, "skip", _BF, (bsz, h, wd, cs))
    cuda.check(w, "w", _BF, (3, 3, cx + cs, cout))
    cuda.check(b, "b", _BF, (cout,))
    if ln_scale is not None:
        cuda.check(ln_scale, "ln_scale", _BF, (cout,))
        cuda.check(ln_bias, "ln_bias", _BF, (cout,))
    out = torch.empty((bsz, h, wd, cout), dtype=_BF, device=x.device)
    geo = DecoderConvTiling(bsz, h, wd, cx, cs, cout, slots=_k7_slots(cout, x.device))
    wl = k7_weight_layout(w)
    cuda.launch(
        "decoder_conv", "decoder_conv_launch", cuda.ptr(xb), cuda.ptr(sb), cuda.ptr(wl),
        cuda.ptr(b), cuda.ptr(ln_scale), cuda.ptr(ln_bias), cuda.ptr(out),
        bsz, h, wd, cx, cs, cout, int(exact_gelu), *geo.launch_args(), cuda.stream(xb),
    )
    decoder_conv.launches += 1
    return out


@functools.cache
def _k7_slots(cout: int, device: torch.device) -> int:
    """Blocks of K7's kernel for ``cout`` that fit the card at once, in
    whole clusters (the kernel's own occupancy query)."""
    n = cuda.size_query("decoder_conv", "decoder_conv_slots", device, cout)
    if n <= 0:
        raise RuntimeError(f"decoder_conv: no cluster of the cout {cout} kernel fits the card")
    return n


def _check_up(cin: int, cout: int, name: str) -> None:
    if cin != UP_CHANNELS or cout != UP_CHANNELS:
        raise ValueError(f"{name} kernel takes cin = cout = {UP_CHANNELS}, got {cin}, {cout}")


def final_conv_gelu(x, w, b, exact_gelu: bool = False):
    """Full-resolution 3x3 conv + bias + GELU: x (B, H, W, cin), w (3, 3,
    cin, cout) → (B, H, W, cout) bf16. H must be a multiple of 32, on both
    devices, as the TPU kernel requires at its default ``rows=32``; any W
    and batch: offsets are 64-bit, so one call takes a TTA x4 batch of 128
    tiles (2^31 elements). The kernel takes cin = cout = 64."""
    bsz, h, wd, cin = x.shape
    if h % FINAL_CONV_ROWS:
        raise ValueError(f"H={h} must be a multiple of rows={FINAL_CONV_ROWS}")
    if not x.is_cuda:
        return final_conv_gelu_plain(x, w, b, exact_gelu)
    cout = w.shape[-1]
    _check_up(cin, cout, "final_conv_gelu")
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(w, "w", _BF, (3, 3, cin, cout))
    cuda.check(b, "b", _BF, (cout,))
    out = torch.empty((bsz, h, wd, cout), dtype=_BF, device=x.device)
    geo = StripTiling(bsz, h, wd, n_sm=cuda.sm_count(x.device))
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
    shared memory; it takes cin = cout = 64. 2H must be a multiple of 4, as
    the TPU kernel requires (it writes the output in 4 row chunks)."""
    bsz, h, wd, cin = x.shape
    if (2 * h) % 4:
        raise ValueError(f"2*H must be a multiple of 4, got H={h}")
    if not x.is_cuda:
        return upsample_final_plain(x, w, b, exact_gelu)
    cout = w.shape[-1]
    _check_up(cin, cout, "upsample_final")
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(w, "w", _BF, (3, 3, cin, cout))
    cuda.check(b, "b", _BF, (cout,))
    out = torch.empty((bsz, 2 * h, 2 * wd, cout), dtype=_BF, device=x.device)
    geo = UpsampleTiling(bsz, h, wd, n_sm=cuda.sm_count(x.device))
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
    cout = 64 and n_out <= 16. 2H must be a multiple of 4, on both devices,
    as the TPU kernel requires (it writes the output in 4 row chunks)."""
    bsz, h, wd, cin = x.shape
    if (2 * h) % 4:
        raise ValueError(f"2*H must be a multiple of 4, got H={h}")
    if not x.is_cuda:
        return final_heads_plain(x, w, b, wh, bh, exact_gelu)
    cout, n_out = w.shape[-1], wh.shape[-1]
    _check_up(cin, cout, "final_heads")
    if not 0 < n_out <= UP_HEAD_COLS:
        raise ValueError(f"final_heads kernel takes 0 < n_out <= {UP_HEAD_COLS}, got {n_out}")
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(w, "w", _BF, (3, 3, cin, cout))
    cuda.check(b, "b", _BF, (cout,))
    cuda.check(wh, "wh", _BF, (cout, n_out))
    cuda.check(bh, "bh", _BF, (n_out,))
    out = torch.empty((bsz, 2 * h, 2 * wd, n_out), dtype=_BF, device=x.device)
    geo = UpsampleTiling(bsz, h, wd, head=True, n_sm=cuda.sm_count(x.device))
    cuda.launch(
        "upsample_conv", "final_heads_launch", cuda.ptr(xb), cuda.ptr(w), cuda.ptr(b),
        cuda.ptr(wh), cuda.ptr(bh), cuda.ptr(out), bsz, h, wd, cin, cout, n_out,
        int(exact_gelu), *geo.launch_args(), cuda.stream(xb),
    )
    final_heads.launches += 1
    return out


def check_block_diagonal(wh_bd: torch.Tensor, phases: int = K11_PHASES) -> None:
    """Raise unless ``wh_bd`` (phases c, phases n) is zero off its diagonal
    (c, n) blocks, which K11's kernel does not read. Costs one device sync
    for a head on the card."""
    c4, n4 = wh_bd.shape
    if c4 % phases or n4 % phases:
        raise ValueError(f"wh_bd {tuple(wh_bd.shape)} is no {phases} x {phases} grid of blocks")
    blocks = wh_bd.reshape(phases, c4 // phases, phases, n4 // phases).transpose(1, 2)
    off = ~torch.eye(phases, dtype=torch.bool, device=wh_bd.device)
    if bool(blocks[off].any()):
        raise ValueError("composite_final_heads: wh_bd has nonzero blocks off its diagonal; the "
                         "kernel reads only the diagonal (cout, n_out) block of each phase")


def composite_final_heads(x, wc, bias4, wh_bd, bh4, exact_gelu: bool = False,
                          block_diagonal: bool = False):
    """The final stage in the low-res parity domain: x (B, H, W, cin), wc
    (3, 3, cin, 4 cout) parity-folded weights, bias4 (4 cout,), wh_bd
    (4 cout, 4 n_out) block-diagonal heads, bh4 (4 n_out,) → (B, H, W,
    4 n_out) bf16 parity logits, phase-major (a, b) = 00, 01, 10, 11.

    Precondition, as the TPU kernel's: wh_bd is block-diagonal (the head
    repeated per phase, ``hovernext_fn._block_diag_heads``), so that phase
    p's logits depend only on its own cout channels. The plain version
    multiplies the whole matrix; the kernel runs each phase as a conv
    cin → cout with its diagonal head block and reads no other block, so
    on the card a head with nonzero off-diagonal blocks is refused
    (``check_block_diagonal``, one device sync) rather than answered
    wrongly. ``block_diagonal=True`` states that wh_bd was built
    block-diagonal, as ``hovernext_fn.k11_weights`` builds it, and skips
    that check, so that the call is enqueued without waiting for the
    device. The kernel takes cin = cout = 64 and n_out <= 16."""
    if not x.is_cuda:
        return composite_final_heads_plain(x, wc, bias4, wh_bd, bh4, exact_gelu)
    bsz, h, wd, cin = x.shape
    c4, n4 = wc.shape[-1], wh_bd.shape[-1]
    _check_up(cin, c4 // K11_PHASES, "composite_final_heads")
    if c4 % K11_PHASES or n4 % K11_PHASES or not 0 < n4 // K11_PHASES <= UP_HEAD_COLS:
        raise ValueError(f"composite_final_heads kernel takes c4 = {K11_PHASES} x {UP_CHANNELS} "
                         f"and n4 = {K11_PHASES} x n_out, 0 < n_out <= {UP_HEAD_COLS}, got "
                         f"{c4}, {n4}")
    xb = _act(x)
    cuda.check(xb, "x", _BF, (bsz, h, wd, cin))
    cuda.check(wc, "wc", _BF, (3, 3, cin, c4))
    cuda.check(bias4, "bias4", _BF, (c4,))
    cuda.check(wh_bd, "wh_bd", _BF, (c4, n4))
    cuda.check(bh4, "bh4", _BF, (n4,))
    if not block_diagonal:
        check_block_diagonal(wh_bd)
    out = torch.empty((bsz, h, wd, n4), dtype=_BF, device=x.device)
    geo = StripTiling(bsz, h, wd, phases=K11_PHASES, n_sm=cuda.sm_count(x.device))
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
