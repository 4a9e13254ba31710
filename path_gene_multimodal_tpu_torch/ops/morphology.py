"""Binary morphology by convolution, and the Gaussian blur.

A copy of the JAX package's ``ops/morphology.py``: ``disk``,
``ellipse_kernel`` (cv2's ``MORPH_ELLIPSE`` rule, written out: the port
does not use cv2), binary dilation / erosion / closing / opening with a
structuring element (SE) and ``gaussian_blur``. The JAX package runs them
as XLA convolutions, not Pallas kernels; here each is ``F.conv2d`` on any
device, the binary ones counting SE-covered foreground, exact in float32
(integer counts below 2^24).

Border semantics match skimage: out-of-image pixels are False for
dilation and True for erosion, so foreground touching the border survives
a closing.
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


def ellipse_kernel(h: int, w: int) -> np.ndarray:
    """``cv2.getStructuringElement(MORPH_ELLIPSE, (w, h))``: row i spans
    columns c ± round(c · sqrt(1 − (i − r)² / r²)), r = h // 2, c = w // 2
    (cv2's rule, rounded half to even as ``cvRound``)."""
    h, w = int(h), int(w)
    r, c = h // 2, w // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((h, w), np.float32)
    for i in range(h):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0) : min(c + dx + 1, w)] = 1.0
    return out


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


def gaussian_blur(img: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian (skimage.filters.gaussian semantics: 'nearest'
    border mode, radius int(truncate * sigma + 0.5)) — the reference's
    smooth_mask blur (create_and_overlay_polygon_from_prediction.py:173-176).
    (H, W) or (B, H, W) → float32."""
    radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    squeeze = img.dim() == 2
    x = (img[None] if squeeze else img).float()
    kt = torch.as_tensor(k, dtype=torch.float32, device=x.device)
    h, w = x.shape[-2:]
    rows = torch.arange(-radius, h + radius, device=x.device).clamp(0, h - 1)
    x = F.conv2d(x[:, rows][:, None], kt[None, None, :, None])[:, 0]
    cols = torch.arange(-radius, w + radius, device=x.device).clamp(0, w - 1)
    x = F.conv2d(x[:, :, cols][:, None], kt[None, None, None, :])[:, 0]
    return x[0] if squeeze else x
