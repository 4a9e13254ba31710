"""Tissue masking: RGB → HSV and the HSV-saturation tissue mask.

A copy of the part of the JAX package's ``ops/masking.py`` that the
tissue-boundary path uses (``rgb_to_hsv``, ``tissue_mask_hsv``), in torch
on any device. It repeats the float32 operations of the JAX function as
XLA compiles it under ``jit`` (how the JAX pipeline runs it), which
multiplies by the reciprocal where the source divides by a constant (1/255,
1/6), so the masks agree bit for bit. Otsu and ``tissue_mask`` come with
tessellation (ROADMAP, Queue 1).
"""

from __future__ import annotations

import torch


def _recip(c: float, like: torch.Tensor) -> torch.Tensor:
    """1 / c rounded to float32, as XLA folds a division by a constant."""
    return torch.tensor(1.0 / c, dtype=torch.float32, device=like.device)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB (..., 3) → float32 HSV with H, S, V ∈ [0, 1]
    (matplotlib/skimage ``rgb2hsv`` semantics; hue wraps at 1.0)."""
    x = rgb.float()
    if not rgb.dtype.is_floating_point:
        x = x * _recip(255.0, x)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h * _recip(6.0, h), 1.0)
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, v], dim=-1)


def tissue_mask_hsv(thumbnail_rgb: torch.Tensor, sat_threshold: float = 0.04) -> torch.Tensor:
    """HSV-saturation mask, ``hsv[..., 1] > sat_threshold`` (the reference's
    polygon_morphology.py:114-121)."""
    return rgb_to_hsv(thumbnail_rgb)[..., 1] > sat_threshold
