"""TME region-of-interest flags — the JAX package's ``ops/tme.py`` in torch
on any device.

Reference (``load_annotation_with_coordinates.py:188-222``): a TME tile is
``in_tme_roi`` iff its patch box intersects
``unary_union(tumor_boxes).buffer(margin)``. Geometry is axis-aligned
boxes, and Minkowski sums distribute over unions, so that predicate is
exactly::

    min over tumor boxes B of  boxdist(tile_box, B)  <=  margin

``boxdist`` corner metric: shapely's ``.buffer`` is NOT a Euclidean disc —
it approximates each convex corner arc with ``quad_segs=8`` inscribed
chords, which sit up to ``margin·(1−cos(π/32)) ≈ 0.48%`` inside the true
radius. ``corners="polygon8"`` reproduces that inscribed-16-gon metric via
its support function (max over the 8 chord normals per quadrant);
``corners="euclid"`` gives the true disc
(``CompatConfig.polygonal_buffer_corners`` selects).

Every step is the float32 operation of the JAX function as XLA compiles it
on the CPU, so that the flags agree with it and between the card and the
CPU: XLA fuses ``a * b + c * d`` into ``fma(a, b, c * d)``, which
``_fma32`` forms in float64 (the product exact) and rounds to float32 —
a single rounding but in the rare case where the float64 sum falls on a
float32 tie (double rounding). torch's own ops would round the product
first on the CPU and leave the contraction to the compiler on the card. The JAX package pads both operands to
doubling buckets for its compile cache; here the tumor boxes are only cut
into chunks of ``chunk`` rows, which bounds memory at N × chunk.
"""

from __future__ import annotations

import numpy as np
import torch

#: chord normals of shapely's quad_segs=8 corner arc (one quadrant): edge k
#: spans θ ∈ [kπ/16, (k+1)π/16] with outward normal at the midpoint and
#: plane offset margin·cos(π/32)
_CHORD_ANGLES = tuple((2 * k + 1) * np.pi / 32.0 for k in range(8))
_CHORD_COS_HALF = float(np.cos(np.pi / 32.0))


def _rect_gaps(a_xy: torch.Tensor, b_xy: torch.Tensor, size: float):
    """Per-axis gaps (0 when projections overlap) between axis-aligned
    ``size``-boxes with top-left corners ``a_xy`` (N, 2), ``b_xy`` (M, 2)."""
    s = torch.tensor(size, dtype=torch.float32, device=a_xy.device)
    ax, ay = a_xy[:, 0:1], a_xy[:, 1:2]
    bx, by = b_xy[None, :, 0], b_xy[None, :, 1]
    dx = torch.clamp(torch.maximum(bx - (ax + s), ax - (bx + s)), min=0.0)
    dy = torch.clamp(torch.maximum(by - (ay + s), ay - (by + s)), min=0.0)
    return dx, dy


def _fma32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (see the module docstring)."""
    return (a.double() * b + c.double()).float()


def _box_dist_sq(dx: torch.Tensor, dy: torch.Tensor, corners: str) -> torch.Tensor:
    """Squared box distance under the chosen corner metric (``euclid``:
    dx² + dy²; ``polygon8``: the squared support-function distance of
    shapely's inscribed corner polygon)."""
    if corners == "euclid":
        return (dx.double() * dx.double() + (dy * dy).double()).float()
    if corners != "polygon8":
        raise ValueError(f"unknown corner metric {corners!r}")
    d = torch.zeros_like(dx)
    for ang in _CHORD_ANGLES:
        c, s = float(np.float32(np.cos(ang))), float(np.float32(np.sin(ang)))
        d = torch.maximum(d, _fma32(dx, c, dy * s))
    d = d * float(np.float32(1.0 / _CHORD_COS_HALF))
    d = torch.where((dx == 0.0) & (dy == 0.0), 0.0, torch.maximum(d, torch.maximum(dx, dy)))
    return d * d


def min_box_distance_sq(
    tile_xy: torch.Tensor,
    tumor_xy: torch.Tensor,
    box_size: float,
    chunk: int = 512,
    corners: str = "polygon8",
) -> torch.Tensor:
    """Per-tile squared distance (f32) to the nearest tumor box, inf when
    there is none. Tumor boxes are taken ``chunk`` rows at a time."""
    tile_xy = tile_xy.float()
    tumor_xy = tumor_xy.float()
    out = torch.full((tile_xy.shape[0],), float("inf"), dtype=torch.float32,
                     device=tile_xy.device)
    for s in range(0, tumor_xy.shape[0], chunk):
        dx, dy = _rect_gaps(tile_xy, tumor_xy[s : s + chunk], box_size)
        out = torch.minimum(out, _box_dist_sq(dx, dy, corners).min(dim=1).values)
    return out


def tme_roi_flags(
    tile_xy: np.ndarray,
    is_tumor: np.ndarray,
    is_tme_eligible: np.ndarray,
    box_size: float,
    margin: float,
    corners: str = "polygon8",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """``in_tme_roi`` per tile (bool, N). A tile is flagged iff it is
    TME-eligible and its box lies within ``margin`` of any tumor box
    (corner metric per the module docstring; ``polygon8`` = the
    reference's shapely buffer). The distances are computed on
    ``device``."""
    tile_xy = np.array(tile_xy, np.float32)
    tumor_xy = tile_xy[np.asarray(is_tumor, bool)]
    if len(tumor_xy) == 0:
        raise ValueError("No tumor tiles found for tumor classes")
    if not np.asarray(is_tme_eligible, bool).any():
        raise ValueError("No TME tiles for the given classes found")
    d2 = min_box_distance_sq(torch.from_numpy(tile_xy).to(device),
                             torch.from_numpy(tumor_xy).to(device), float(box_size),
                             corners=corners).cpu().numpy()
    within = d2 <= np.float32(margin) ** 2
    return within & np.asarray(is_tme_eligible, bool)
