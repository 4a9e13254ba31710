"""Tissue masking: RGB → HSV, Otsu thresholding, foreground masks.

A copy of the JAX package's ``ops/masking.py`` in torch on any device. It
repeats the float32 operations of the JAX functions as XLA compiles them
under ``jit`` (how the JAX pipeline runs them), so that the masks agree bit
for bit:

- a division by a constant (1/255, 1/6) is a multiplication by its
  rounded reciprocal;
- Otsu's cumulative sums follow XLA's rewrite of a 256-long cumulative
  sum into 16 rows of 16: each row summed left to right, the row totals
  summed left to right before each row, then added (``_xla_cumsum_256``).
  ``torch.cumsum`` would sum in double on the CPU and in another order on
  the card, which moves the threshold on some images.
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


def histogram_256(img_u8: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """256-bin int64 histogram of a uint8 image (any shape). ``weights``
    (same shape, 0/1) excludes pixels — the padding of a canonically-shaped
    thumbnail."""
    flat = img_u8.reshape(-1).long()
    w = torch.ones_like(flat) if weights is None else weights.reshape(-1).long()
    return torch.zeros(256, dtype=torch.int64, device=img_u8.device).index_add_(0, flat, w)


def _xla_cumsum_256(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum of a (256,) f32 vector in XLA's order on the CPU: 16
    rows of 16, each prefix-summed left to right; the exclusive prefix of
    the row totals, left to right; the two added."""
    rows = x.reshape(16, 16)
    acc = torch.zeros(16, dtype=x.dtype, device=x.device)
    pref = []
    for c in range(16):
        acc = acc + rows[:, c]
        pref.append(acc)
    pref = torch.stack(pref, dim=1)
    run = torch.zeros((), dtype=x.dtype, device=x.device)
    before = []
    for r in range(16):
        before.append(run)
        run = run + pref[r, 15]
    return (torch.stack(before)[:, None] + pref).reshape(256)


def otsu_threshold(img_u8: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Otsu's threshold over a uint8 image: a uint8 scalar tensor t;
    foreground is ``img > t`` (skimage ``threshold_otsu`` convention)."""
    hist = histogram_256(img_u8, weights).float()
    total = hist.sum()  # integer counts below 2^24: exact in f32
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    w0 = _xla_cumsum_256(hist)
    sum0 = _xla_cumsum_256(hist * bins)
    sum_all = sum0[-1]
    w1 = total - w0
    mu0 = sum0 / torch.clamp(w0, min=1e-12)
    mu1 = (sum_all - sum0) / torch.clamp(w1, min=1e-12)
    d = mu0 - mu1
    between = w0 * w1 * (d * d)
    between = torch.where((w0 > 0) & (w1 > 0), between, -1.0)
    return torch.argmax(between).to(torch.uint8)


def median_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """3×3 median filter (edge-replicated) — the usual smoothing before Otsu
    in WSI foreground segmentation. (H, W) of any dtype."""
    h, w = img.shape
    rows = torch.arange(-1, h + 1, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=img.device).clamp(0, w - 1)
    pad = img[rows][:, cols]
    stack = torch.stack([pad[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)])
    return stack.median(dim=0).values


def tissue_mask(
    thumbnail_rgb: torch.Tensor,
    use_otsu: bool = True,
    segment_threshold: int = 20,
    valid_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Foreground tissue mask from an RGB thumbnail (H, W, 3) uint8 → bool
    (H, W): saturation scaled to uint8 (truncated) → 3×3 median → Otsu (or
    fixed) threshold, with ``segment_threshold`` as its floor (ref
    ``tiling.py:29``).

    ``valid_hw``: the valid extent (rows, cols) of a thumbnail padded to a
    canonical shape: the last valid row and column are replicated into the
    padding before the median, the padding is left out of the histogram and
    is background in the output (the JAX function's canonical-shape path)."""
    sat_u8 = (rgb_to_hsv(thumbnail_rgb)[..., 1] * 255.0).to(torch.uint8)
    valid = None
    if valid_hw is not None:
        h, w = sat_u8.shape
        dev = sat_u8.device
        rows = torch.arange(h, device=dev).clamp(max=int(valid_hw[0]) - 1)
        cols = torch.arange(w, device=dev).clamp(max=int(valid_hw[1]) - 1)
        sat_u8 = sat_u8[rows][:, cols]
        valid = ((torch.arange(h, device=dev) < int(valid_hw[0]))[:, None]
                 & (torch.arange(w, device=dev) < int(valid_hw[1]))[None, :])
    sat_u8 = median_blur_3x3(sat_u8)
    if use_otsu:
        t = torch.clamp(otsu_threshold(sat_u8, valid), min=segment_threshold)
    else:
        t = torch.tensor(segment_threshold, dtype=torch.uint8, device=sat_u8.device)
    mask = sat_u8 > t
    return mask if valid is None else mask & valid
