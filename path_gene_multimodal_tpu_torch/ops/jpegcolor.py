"""Finish a planar 4:2:0 JPEG decode on the tensors' device.

Counterpart of the JAX package's ``ops/jpegcolor.py``. The planar tile
feed ships JPEG tiles as raw 4:2:0 planes (Y at full resolution, Cb/Cr at
a quarter; ``csrc/tiledecode.cpp``, ``decode_jpeg_batch_planar``), half the
bytes of RGB, and ends the decode where the tiles are used: 2x2 nearest
chroma upsampling and libjpeg's fixed-point YCbCr->RGB conversion (jdcolor.c
/ jdmerge.c tables, SCALEBITS 16) in int32 with arithmetic right shifts.
The output equals the decoder's nearest RGB form (``decode_jpeg_batch_
nearest``, libjpeg's merged upsampler) bit for bit. This is plain PyTorch:
the JAX function is XLA, not a Pallas kernel.

Nearest chroma is the planar contract because it commutes with the
even-aligned plane crops of region assembly. The default RGB decode uses
libjpeg's fancy (triangle-filter) chroma instead, and the two are not
close at chroma edges: over 64 tiles of ``synthetic_wsi(2048, 2048,
seed=11)`` at quality 90 they differ by up to 35 levels (mean 0.36, 99.9th
percentile 13; ``tests/test_torch_planar_feed.py`` measures the same
slide). The JAX docstring's "at most +-1 chroma level" does not hold.
"""

from __future__ import annotations

import torch

# libjpeg jdcolor.c fixed-point constants: FIX(x) = int(x * 2**16 + 0.5)
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_FIX_1_40200 = 91881
_FIX_1_77200 = 116130
_FIX_0_71414 = 46802
_FIX_0_34414 = 22554


def ycbcr420_to_rgb(y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
    """uint8 luma (..., H, W) and interleaved chroma (..., ceil(H/2),
    ceil(W/2), 2) -> uint8 RGB (..., H, W, 3) on their device, equal to
    libjpeg's nearest-upsample (merged) decode of the same scan data."""
    h, w = y.shape[-2], y.shape[-1]
    c = cbcr.to(torch.int32) - 128
    c = c.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)[..., :h, :w, :]
    cb, cr = c[..., 0], c[..., 1]
    yi = y.to(torch.int32)
    r = yi + ((_FIX_1_40200 * cr + _ONE_HALF) >> _SCALEBITS)
    g = yi + (((-_FIX_0_34414) * cb + _ONE_HALF + (-_FIX_0_71414) * cr) >> _SCALEBITS)
    b = yi + ((_FIX_1_77200 * cb + _ONE_HALF) >> _SCALEBITS)
    return torch.stack([r, g, b], dim=-1).clamp_(0, 255).to(torch.uint8)

