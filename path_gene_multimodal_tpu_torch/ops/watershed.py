"""Instance decoders: the HoVer-map watershed and the three-class decoder.

Counterpart of the JAX package's ``ops/watershed.py`` (``hv_energy``, the
dense mode of ``hover_instances_batch`` and ``threeclass_instances_batch``,
lines 199-380), whose two decoders share one tail:

1. foreground components smaller than ``min_object_size`` removed (K2,
   ``ops/cc_sizes.py``; ``_filter_small_objects``);
2. markers labeled with dense ids, those smaller than ``min_marker_size``
   dropped (K2), then the marker flood over the foreground following
   descending ``dist`` (K3, ``ops/flood.py``; ``_label_markers_and_flood``).

The HoVer route: foreground ``np_prob > np_threshold``; Sobel gradients of
the H and V maps, each min-max normalised per tile, ``overall =
max(|d/dx h|, |d/dy v|)`` — high at instance boundaries; energy ``dist =
(1 - overall) * fg``; markers ``fg & overall < marker_threshold``.

The three-class route (the published hover_next instance head: background,
interior, border): foreground ``p_interior + p_border > fg_threshold``;
markers ``fg & p_interior > seed_threshold``; energy ``p_interior`` on the
foreground.

Each returns (labels (B, H, W) int32: dense ids 1..N per tile ordered by
marker root pixel, INF background; overflow (1,) int32: tiles whose
component count exceeded the CC slot budget in either CC pass). On CUDA
tensors K2 and K3 run; on CPU tensors their plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.ops.cc_sizes import cc_sizes_adaptive
from path_gene_multimodal_tpu_torch.ops.components import INF
from path_gene_multimodal_tpu_torch.ops.flood import marker_watershed

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _conv3(img: torch.Tensor, k) -> torch.Tensor:
    """3x3 cross-correlation with zero padding, as elementwise shifted
    multiply-adds (no convolution library, so no TF32 on the card)."""
    h, w = img.shape[-2:]
    p = F.pad(img, (1, 1, 1, 1))
    out = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            if k[i][j]:
                out = out + p[:, i : i + h, j : j + w] * (k[i][j] / 8.0)
    return out


def _minmax_norm(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=1e-8)


def hv_energy(h_map: torch.Tensor, v_map: torch.Tensor, blb: torch.Tensor):
    """(B, H, W) H and V maps + foreground → (overall boundary response in
    [0, 1], dist energy), both f32."""
    sobel_y = tuple(zip(*_SOBEL_X))
    sh = _minmax_norm(_conv3(h_map.float(), _SOBEL_X).abs())
    sv = _minmax_norm(_conv3(v_map.float(), sobel_y).abs())
    overall = torch.where(blb, torch.maximum(sh, sv), 0.0)
    dist = (1.0 - overall) * blb.float()
    return overall, dist


def _filter_small_objects(blb: torch.Tensor, min_object_size: int):
    """Foreground components under ``min_object_size`` pixels removed →
    (mask, per-tile overflow flags)."""
    _, sizes, _, over = cc_sizes_adaptive(blb)
    return blb & (sizes >= min_object_size), over


def _label_markers_and_flood(blb: torch.Tensor, dist: torch.Tensor, marker_mask: torch.Tensor,
                             min_marker_size: int, levels: int, over: torch.Tensor):
    """Shared tail of the decoders: dense marker ids (markers under
    ``min_marker_size`` dropped), flooded over ``blb`` following descending
    ``dist`` → (labels, overflow count (1,) int32)."""
    _, _, marker_dense, over2 = cc_sizes_adaptive(marker_mask, min_size=min_marker_size)
    markers = torch.where(marker_dense > 0, marker_dense, INF)
    lbl = marker_watershed(dist, markers, blb, levels=levels)
    return lbl, (over | over2).sum().to(torch.int32).reshape(1)


def hover_instances_batch(
    np_prob: torch.Tensor,
    hv: torch.Tensor,
    np_threshold: float = 0.5,
    marker_threshold: float = 0.4,
    min_object_size: int = 10,
    min_marker_size: int = 3,
    levels: int = 64,
):
    """(B, H, W) foreground probabilities + (B, H, W, 2) HV maps →
    (labels, overflow) as the module says."""
    blb, over = _filter_small_objects(np_prob > np_threshold, min_object_size)
    overall, dist = hv_energy(hv[..., 0], hv[..., 1], blb)
    marker_mask = blb & (overall < marker_threshold)
    return _label_markers_and_flood(blb, dist, marker_mask, min_marker_size, levels, over)


def threeclass_instances_batch(
    inst_logits: torch.Tensor,
    fg_threshold: float = 0.5,
    seed_threshold: float = 0.8,
    min_object_size: int = 10,
    min_marker_size: int = 3,
    levels: int = 64,
):
    """(B, H, W, 3) logits over (background, interior, border) → (labels,
    overflow) as the module says: seeds of confident interior flood through
    decreasing P(interior) until the foreground ends, so the border class
    separates touching nuclei."""
    return threeclass_instances_from_probs(
        torch.softmax(inst_logits.float(), dim=-1), fg_threshold, seed_threshold,
        min_object_size, min_marker_size, levels)


def threeclass_instances_from_probs(
    p: torch.Tensor,
    fg_threshold: float = 0.5,
    seed_threshold: float = 0.8,
    min_object_size: int = 10,
    min_marker_size: int = 3,
    levels: int = 64,
):
    """``threeclass_instances_batch`` from the softmax ``p`` (B, H, W, 3)
    f32, so that two devices can be held to each other on one set of
    probabilities."""
    p_interior = p[..., 1]
    fg, over = _filter_small_objects((p_interior + p[..., 2]) > fg_threshold, min_object_size)
    marker_mask = fg & (p_interior > seed_threshold)
    dist = torch.where(fg, p_interior, 0.0)
    return _label_markers_and_flood(fg, dist, marker_mask, min_marker_size, levels, over)
