"""Binary morphology by convolution.

A copy of the part of the JAX package's ``ops/morphology.py`` that the
tissue-boundary path uses: ``disk`` and binary dilation / erosion /
closing / opening with a structuring element (SE). The JAX package runs
them as XLA convolutions, not Pallas kernels; here they are one
``F.conv2d`` counting SE-covered foreground, exact in float32 (integer
counts below 2^24), on any device.

Border semantics match skimage: out-of-image pixels are False for
dilation and True for erosion, so foreground touching the border survives
a closing. ``ellipse_kernel`` and ``gaussian_blur`` come with the polygons
slice (ROADMAP, Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk: (2r+1)² grid, x²+y² ≤ r²."""
    r = int(radius)
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    return (xx * xx + yy * yy <= r * r).astype(np.float32)


def _conv_count(mask: torch.Tensor, se: np.ndarray, pad_value: float) -> torch.Tensor:
    """Count of SE-covered foreground at each pixel, the border filled with
    ``pad_value``. mask: (..., H, W) with one optional leading batch axis."""
    squeeze = mask.dim() == 2
    if squeeze:
        mask = mask[None]
    k = torch.as_tensor(np.asarray(se, np.float32), device=mask.device)
    kh, kw = k.shape
    x = F.pad(mask.float(), (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
              value=pad_value)
    out = F.conv2d(x[:, None], k[None, None])[:, 0]
    return out[0] if squeeze else out


def binary_dilation(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return _conv_count(mask, se, 0.0) > 0.5


def binary_erosion(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    se = np.asarray(se)
    return _conv_count(mask, se, 1.0) > float(se.sum()) - 0.5


def binary_closing(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return binary_erosion(binary_dilation(mask, se), se)


def binary_opening(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return binary_dilation(binary_erosion(mask, se), se)
