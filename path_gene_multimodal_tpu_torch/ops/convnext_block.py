"""K1: the ConvNeXtV2 block (dw 7x7 + LN + pw1 + GELU + GRN + pw2 +
residual) as one kernel call.

Counterpart of the JAX package's ``ops/pallas/convnext_block.py``
(``fused_convnext_block``). On a CUDA tensor ``convnext_block`` launches
the hand-written kernel in ``csrc/convnext_block.cu`` (three launches: dw
7x7 + LayerNorm into a bf16 ``a``, pw1 + GELU into an f32 ``y2`` with the
per-image sums of its squares, GRN + pw2 + residual; ``ConvNeXtTiling`` is
their geometry); on a CPU tensor it runs ``convnext_block_plain``, which
repeats the TPU kernel's arithmetic op for op (bf16 storage, f32
accumulation, bf16 rounding of each pointwise product's operand: the GRN
affine reads the f32 GELU output y2, and its result y3 is rounded before
pw2, in all three). The plain version is also cut at the kernel's launches
(``dw_ln_plain``, ``pw1_plain``, ``pw2_plain``) so that each launch can be
held against its own part.

Where a product is followed by a sum (the LayerNorm affine, the GRN scale
``gamma * nx + 1`` and ``y3 = y2 * scale + beta``), the kernel and the
JAX reference on the CPU (XLA fuses them) round once, as a fused
multiply-add: the plain version does too (``_fma``). The GRN mean over the
channels is the correctly rounded f32 of a double sum in the kernel and
here (the reference's is an f32 sum in XLA's order, which no other order
repeats), so that pw2 fed the same y2 and sums rounds y3 exactly as the
kernel does. The f32 products run with TF32 off whatever the caller's flags
(``cuda.exact_f32``).

The kernel takes C a multiple of 32 up to 384 (``check_channels``); the
Pallas kernel and the plain version take any C.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.ops import cuda

KERNEL_SIZE = 7
PAD = KERNEL_SIZE // 2


def gelu(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """GELU in the flavor the config selects (tanh unless ``exact``)."""
    return F.gelu(x, approximate="none" if exact else "tanh")


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz-Stegun 7.1.26, as the TPU kernel computes it."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_kernel(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """GELU as the TPU kernels compute it: tanh, or exact through the
    Abramowitz-Stegun erf polynomial (not ``torch.erf``)."""
    if exact:
        return 0.5 * x * (1.0 + _erf_as(x * 0.7071067811865476))
    k = 0.7978845608028654
    return 0.5 * x * (1.0 + torch.tanh(k * (x + 0.044715 * x * x * x)))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as a fused multiply-add: a and b are
    f32 (or bf16-valued), so their product is exact in f64."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def dw_plain(x, dw, dwb) -> torch.Tensor:
    """dw 7x7 (zero padding, taps summed dx-major) + bias, in f32: the
    LayerNorm's input in launch 0."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    b, h, w, c = x.shape
    xf = f(x)
    dwk = f(dw)
    xp = F.pad(xf, (0, 0, PAD, PAD, PAD, PAD))
    acc = torch.zeros_like(xf)
    for dx in range(KERNEL_SIZE):
        for dy in range(KERNEL_SIZE):
            acc = acc + xp[:, dy : dy + h, dx : dx + w, :] * dwk[dy, dx]
    return acc + f(dwb)


def dw_ln_plain(x, dw, dwb, ln_gamma, ln_beta) -> torch.Tensor:
    """Launch 0's function: dw 7x7 + bias + LayerNorm over C, in f32 (the
    kernel stores it rounded to bf16, the operand pw1 rounds to)."""
    return layer_norm_plain(dw_plain(x, dw, dwb), ln_gamma, ln_beta)


def layer_norm_plain(acc, ln_gamma, ln_beta) -> torch.Tensor:
    """LayerNorm over the last axis in two passes (mean, then the centred
    variance), eps 1e-6, as the TPU kernel takes it; the affine as one
    fused multiply-add."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    mu = acc.mean(-1, keepdim=True)
    var = (acc - mu).square().mean(-1, keepdim=True)
    t = (acc - mu) * torch.rsqrt(var + 1e-6)
    return _fma(t, f(ln_gamma).expand_as(t), f(ln_beta).expand_as(t))


@cuda.exact_f32()
def pw1_plain(a, w1, b1, exact_gelu: bool = False) -> torch.Tensor:
    """Launch 1's function: pw1 on bf16(a) + bias + GELU, f32 y2 of shape
    (B, pixels, 4C) from a (B, H, W, C) or (B, pixels, C)."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    b, c = a.shape[0], a.shape[-1]
    y2 = f(a).reshape(-1, c) @ f(w1) + f(b1)
    return gelu_kernel(y2, exact_gelu).reshape(b, -1, 4 * c)


def grn_plain(y2, gsum, grn_gamma, grn_beta) -> torch.Tensor:
    """The GRN affine of launch 2 on the f32 y2 (B, pixels, 4C), given the
    per-image sums of its squares gsum (B, 4C): y3 = y2 * (gamma * nx + 1)
    + beta, each a fused multiply-add, rounded to bf16 (held in f32)."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    gx = torch.sqrt(gsum.float() + 1e-12)[:, None, :]
    mean = (gx.double().sum(-1, keepdim=True) / gx.shape[-1]).float()
    nx = gx / (mean + 1e-6)
    scale = _fma(f(grn_gamma).expand_as(nx), nx, torch.ones_like(nx))
    beta = f(grn_beta)
    # image by image: the f64 products of the fused multiply-add stay small
    return torch.cat([f(_fma(y, s.expand_as(y), beta.expand_as(y)))
                      for y, s in zip(y2.split(1), scale.split(1))])


@cuda.exact_f32()
def pw2_plain(x, y2, gsum, grn_gamma, grn_beta, w2, b2) -> torch.Tensor:
    """Launch 2's function: the GRN affine (``grn_plain``), pw2 on bf16(y3)
    + bias + the residual x, bf16 out (B, H, W, C)."""
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    b, h, w, c = x.shape
    y3 = grn_plain(y2, gsum, grn_gamma, grn_beta)
    y4 = y3.reshape(-1, 4 * c) @ f(w2) + f(b2)
    return (f(x) + y4.reshape(b, h, w, c)).to(torch.bfloat16)


def pw_plain(x, y, w1, b1, grn_gamma, grn_beta, w2, b2, exact_gelu: bool = False) -> torch.Tensor:
    """Launches 1 and 2's function on the LayerNorm output y: pw1 on
    bf16(y) + GELU, the GRN affine on the f32 y2 (and its sums of squares),
    pw2 on bf16(y3) + bias + the residual x."""
    y2 = pw1_plain(y, w1, b1, exact_gelu)
    return pw2_plain(x, y2, y2.square().sum(1), grn_gamma, grn_beta, w2, b2)


def convnext_block_plain(
    x, dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2,
    exact_gelu: bool = False,
) -> torch.Tensor:
    """x (B, H, W, C) → block output (B, H, W, C) bf16. Weights as the JAX
    kernel takes them: dw (7, 7, C), w1 (C, 4C), w2 (4C, C), vectors (C,)
    or (4C,). The kernel's three launches round where this does."""
    y = dw_ln_plain(x, dw, dwb, ln_gamma, ln_beta)
    return pw_plain(x, y, w1, b1, grn_gamma, grn_beta, w2, b2, exact_gelu)


C_MULTIPLE = 32  # the kernel's K chunk: C and 4C are whole chunks
MAX_C = 384  # launch 0's ring and weights fill a block's shared memory at C = 384,
# and launch 2's N tile (its f32 accumulators) is at most 192 wide


def check_channels(c: int, what: str = "x") -> None:
    """Raise unless K1's kernel takes ``c`` channels."""
    if c <= 0 or c % C_MULTIPLE or c > MAX_C:
        raise ValueError(f"{what}: the convnext_block kernel (K1) takes C a multiple of "
                         f"{C_MULTIPLE} up to {MAX_C}, got C = {c}")


@dataclass(frozen=True)
class ConvNeXtTiling:
    """Launch geometry of K1's three launches (``csrc/convnext_block.cu``)
    on a (batch, h, w, c) block input; the launchers check what they are
    given against their own.

    - Launch 0 (dw 7x7 + LN): a block per (image, strip of ``dw_strip``
      rows, column tile of ``dw_tile_w``), one thread per (column, 4
      channels) computing ``dw_rows`` output rows per step; the input rows
      slide through a ring of ``ring_rows`` rows of ``dw_tile_w + 6``
      pixels in shared memory (the rows a step reads and the next step's,
      copied ahead).
    - Launches 1 (pw1) and 2 (pw2): a block per (128-pixel tile, N tile),
      the N tile fastest; an image's pixels are cut into ``tiles_per_img``
      tiles, the last one masked, so no tile holds two images. N tiles are
      128 wide in pw1 (of 4C) and ``pw2_n_tile`` in pw2 (of C). A and B
      stream through a ring of ``pw1_stages`` / ``pw2_stages`` K chunks of
      32. y2 lies in device memory in f32 between them: pw1 writes it
      through an f32 staging, and a pw2 stage holds the f32 chunk beside
      the bf16 A tile it is turned into.
    """

    m_tile: ClassVar[int] = 128
    n1_tile: ClassVar[int] = 128
    k_chunk: ClassVar[int] = 32
    pw1_stages: ClassVar[int] = 4
    ring_rows: ClassVar[int] = 14
    dw_rows: ClassVar[int] = 4
    max_strip: ClassVar[int] = 64
    max_dw_threads: ClassVar[int] = 768
    gemm_threads: ClassVar[int] = 256
    gemm_warps: ClassVar[int] = 8

    batch: int
    h: int
    w: int
    c: int

    def __post_init__(self):
        check_channels(self.c)

    @property
    def hw(self) -> int:
        return self.h * self.w

    @property
    def dw_tile_w(self) -> int:
        tw = 64
        while tw * self.c // 4 > self.max_dw_threads:
            tw //= 2
        return tw

    @property
    def dw_strip(self) -> int:
        return min(self.h, self.max_strip)

    @property
    def dw_threads(self) -> int:
        return self.dw_tile_w * self.c // 4

    @property
    def dw_grid(self) -> int:
        return self.batch * -(-self.h // self.dw_strip) * -(-self.w // self.dw_tile_w)

    @property
    def dw_smem(self) -> int:
        """The input ring (bf16), the dw weights (f32), the LayerNorm
        partial sums (one per 32 channels) and per-pixel statistic (f32)
        of a step's rows."""
        tw, c = self.dw_tile_w, self.c
        stats = self.dw_rows * (self.dw_threads // 8 + tw)
        return self.ring_rows * (tw + 6) * c * 2 + 49 * c * 4 + stats * 4

    @property
    def tiles_per_img(self) -> int:
        return -(-self.hw // self.m_tile)

    def m_tiles(self) -> list[tuple[int, int, int]]:
        """(image, first pixel, end pixel) of each 128-pixel tile, in block order."""
        return [(i, t * self.m_tile, min((t + 1) * self.m_tile, self.hw))
                for i in range(self.batch) for t in range(self.tiles_per_img)]

    @property
    def grn_words(self) -> int:
        """f32 words of the GRN scratch: the per-image sums (B, 4C), each
        tile's sums (B, tiles_per_img, 4C) that the last tile of an image
        adds in tile order, and a counter per (image, pw1 N tile)."""
        c4 = 4 * self.c
        return self.batch * (c4 * (1 + self.tiles_per_img) + c4 // self.n1_tile)

    @property
    def pw1_grid(self) -> int:
        return self.batch * self.tiles_per_img * (4 * self.c // self.n1_tile)

    @property
    def pw1_ring(self) -> int:
        """The region of the ring (A and B chunks), which the f32 y2
        staging later lies over: the larger of the two."""
        ring = self.pw1_stages * (self.m_tile + self.n1_tile) * self.k_chunk * 2
        return max(ring, self.pw1_staging)

    @property
    def pw1_smem(self) -> int:
        """The ring region and the per-warp sums of y2^2."""
        return self.pw1_ring + self.gemm_warps * self.n1_tile * 4

    @property
    def pw1_staging(self) -> int:
        return self.m_tile * (self.n1_tile + 4) * 4

    @property
    def pw2_n_tile(self) -> int:
        return next(n for n in (192, 128, 96, 64, 32) if self.c % n == 0)

    @property
    def pw2_stages(self) -> int:
        """Five at the 192-wide N tile, where six stages of f32 y2 chunks
        would not fit a block's shared memory; six otherwise."""
        return 5 if self.pw2_n_tile >= 192 else 6

    @property
    def pw2_grid(self) -> int:
        return self.batch * self.tiles_per_img * (self.c // self.pw2_n_tile)

    @property
    def pw2_ring(self) -> int:
        """The ring: per stage the f32 y2 chunk, its bf16 A tile and the
        bf16 w2 chunk."""
        stage = self.m_tile * self.k_chunk * (4 + 2) + self.pw2_n_tile * self.k_chunk * 2
        return self.pw2_stages * stage

    @property
    def pw2_smem(self) -> int:
        """The ring and the per-channel GRN scale and shift (f32, 4C each);
        the output staging (128 x (N tile + 8) bf16) lies over the ring."""
        return self.pw2_ring + 2 * 4 * self.c * 4

    @property
    def pw2_staging(self) -> int:
        return self.m_tile * (self.pw2_n_tile + 8) * 2

    def dw_args(self) -> tuple[int, int, int, int]:
        return self.dw_tile_w, self.dw_strip, self.dw_threads, self.dw_smem

    def launch_args(self) -> tuple[int, ...]:
        """As ``convnext_block_launch`` takes them: (dw tile width, dw
        strip, dw threads, dw smem, M tile, pw1 N tile, pw2 N tile, pw1
        smem, pw2 smem)."""
        return (*self.dw_args(), self.m_tile, self.n1_tile, self.pw2_n_tile, self.pw1_smem,
                self.pw2_smem)

    def bytes_moved(self) -> dict[str, int]:
        """Device-memory bytes each launch must move at least: its inputs
        read once and its outputs written once (weights included)."""
        px, c = self.batch * self.hw, self.c
        return {"dw_ln": 2 * px * c * 2 + 2 * (49 * c + 3 * c),
                "pw1": 2 * px * c + 4 * px * 4 * c + 2 * (4 * c * c + 4 * c) + 4 * self.batch * 4 * c,
                "pw2": 4 * px * 4 * c + 2 * 2 * px * c + 2 * (4 * c * c + 9 * c)
                + 4 * self.batch * 4 * c}

    def flops(self) -> dict[str, int]:
        """Tensor-core operations of the two products (2 per multiply-add)."""
        px, c = self.batch * self.hw, self.c
        return {"pw1": 2 * px * c * 4 * c, "pw2": 2 * px * 4 * c * c}


def _kernel_args(x, wts):
    """Check the block's input and weights for the kernel; returns the bf16
    input and the weight pointers in the launcher's order (w1 and w2 as
    their transposes, nn.Linear's layout)."""
    b, h, w, c = x.shape
    check_channels(c)
    bf = torch.bfloat16
    xb = (x if x.dtype == bf else x.to(bf)).contiguous()
    cuda.check(xb, "x", bf, (b, h, w, c))
    shapes = [(KERNEL_SIZE, KERNEL_SIZE, c), (c,), (c,), (c,), (c, 4 * c), (4 * c,),
              (4 * c,), (4 * c,), (4 * c, c), (c,)]
    ptrs = []
    for i, (t, shp) in enumerate(zip(wts, shapes)):
        if i in (4, 8):  # w1 (C, 4C), w2 (4C, C): transposed views of contiguous tensors
            if tuple(t.shape) != shp:
                raise ValueError(f"weight {i}: expected shape {shp}, got {tuple(t.shape)}")
            t = t.t()
            if not t.is_contiguous():
                raise ValueError(f"weight {i}: the kernel takes the transpose of a contiguous "
                                 "tensor (nn.Linear's weight, as Block.kernel_weights holds it)")
            shp = shp[::-1]
        cuda.check(t, f"weight {i}", bf, shp)
        ptrs.append(cuda.ptr(t))
    return xb, ptrs


def launch_parts(x, wts, exact_gelu: bool = False) -> dict:
    """K1's three launches on their own, for timing them one by one: a
    dict of callables (``dw_ln``, ``pw1``, ``pw2``) on preallocated
    buffers, and the tiling. They count no launch. x on the card."""
    xb, ptrs = _kernel_args(x, wts)
    b, h, w, c = xb.shape
    geo = ConvNeXtTiling(b, h, w, c)
    dev = xb.device
    a = torch.empty((b, h * w, c), dtype=torch.bfloat16, device=dev)
    y2 = torch.empty((b, h * w, 4 * c), dtype=torch.float32, device=dev)
    grn = torch.zeros(geo.grn_words, dtype=torch.float32, device=dev)  # pw1 re-zeroes its counters
    out = torch.empty_like(xb)
    dw, dwb, lng, lnb, w1t, b1, gg, gb, w2t, b2 = ptrs
    lib = "convnext_block"
    return {
        "dw_ln": lambda: cuda.launch(lib, "convnext_dw_ln_launch", cuda.ptr(xb), dw, dwb, lng,
                                     lnb, cuda.ptr(a), b, h, w, c, *geo.dw_args(),
                                     cuda.stream(dev)),
        "pw1": lambda: cuda.launch(lib, "convnext_pw1_launch", cuda.ptr(a), w1t, b1,
                                   cuda.ptr(y2), cuda.ptr(grn), b, h * w, c, int(exact_gelu),
                                   geo.m_tile, geo.n1_tile, geo.pw1_smem, cuda.stream(dev)),
        "pw2": lambda: cuda.launch(lib, "convnext_pw2_launch", cuda.ptr(y2), cuda.ptr(grn),
                                   gg, gb, w2t, b2, cuda.ptr(xb), cuda.ptr(out), b, h * w, c,
                                   geo.m_tile, geo.pw2_n_tile, geo.pw2_smem, cuda.stream(dev)),
        "tiling": geo,
        "buffers": (a, y2, grn[: b * 4 * c].view(b, 4 * c), out),
    }


def convnext_block(
    x, dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2,
    exact_gelu: bool = False,
) -> torch.Tensor:
    """ConvNeXtV2 block on (B, H, W, C) → bf16 (B, H, W, C): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor. The kernel
    takes its weights as ``Block.kernel_weights`` holds them (bf16, the
    plain version's shapes, w1 and w2 the transposes of contiguous
    tensors) and C as ``check_channels`` says, and raises on anything
    else."""
    if not x.is_cuda:
        return convnext_block_plain(
            x, dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2,
            exact_gelu,
        )
    xb, ptrs = _kernel_args(x, (dw, dwb, ln_gamma, ln_beta, w1, b1, grn_gamma, grn_beta, w2, b2))
    b, h, w, c = xb.shape
    geo = ConvNeXtTiling(b, h, w, c)
    bf = torch.bfloat16
    a = torch.empty((b, h * w, c), dtype=bf, device=x.device)
    y2 = torch.empty((b, h * w, 4 * c), dtype=torch.float32, device=x.device)
    grn = torch.empty(geo.grn_words, dtype=torch.float32, device=x.device)  # counters zeroed there
    out = torch.empty_like(xb)
    cuda.launch(
        "convnext_block", "convnext_block_launch",
        cuda.ptr(xb), *ptrs, cuda.ptr(a), cuda.ptr(y2), cuda.ptr(grn), cuda.ptr(out),
        b, h, w, c, int(exact_gelu), *geo.launch_args(), cuda.stream(xb),
    )
    convnext_block.launches += 1
    return out


convnext_block.launches = 0
