"""HoVer-map watershed post-processing.

Counterpart of the JAX package's ``ops/watershed.py`` (``hv_energy`` and
the dense mode of ``hover_instances_batch``, lines 199-330):

1. foreground ``np_prob > np_threshold``, components smaller than
   ``min_object_size`` removed (K2, ``ops/cc_sizes.py``);
2. Sobel gradients of the H and V maps, each min-max normalised per tile,
   ``overall = max(|d/dx h|, |d/dy v|)`` — high at instance boundaries;
3. energy ``dist = (1 - overall) * fg``; markers = ``fg & overall <
   marker_threshold``, labeled with dense ids, those smaller than
   ``min_marker_size`` dropped (K2);
4. the marker flood over ``fg`` following descending ``dist`` (K3,
   ``ops/flood.py``).
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
    (labels (B, H, W) int32: dense ids 1..N per tile ordered by marker root
    pixel, INF background; overflow (1,) int32: tiles whose component count
    exceeded the CC slot budget in either CC pass)."""
    blb = np_prob > np_threshold
    _, sizes, _, over1 = cc_sizes_adaptive(blb)
    blb = blb & (sizes >= min_object_size)
    overall, dist = hv_energy(hv[..., 0], hv[..., 1], blb)
    marker_mask = blb & (overall < marker_threshold)
    _, _, marker_dense, over2 = cc_sizes_adaptive(marker_mask, min_size=min_marker_size)
    markers = torch.where(marker_dense > 0, marker_dense, INF)
    lbl = marker_watershed(dist, markers, blb, levels=levels)
    return lbl, (over1 | over2).sum().to(torch.int32).reshape(1)
