"""K3: the marker watershed flood.

Counterpart of the JAX package's ``ops/pallas/flood.py``
(``pallas_marker_watershed``). On a CUDA tensor ``marker_watershed``
launches ``csrc/flood.cu``; on a CPU tensor it runs
``marker_watershed_plain``. Both follow the Pallas kernel, which is what
runs on the accelerator: per level and phase, 1 + ``max_rounds`` (= 65)
synchronous steps at most. (The JAX package's XLA flood,
``ops/watershed.py::marker_watershed``, runs 64; the two differ wherever
that cap binds.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from path_gene_multimodal_tpu_torch.ops import cuda
from path_gene_multimodal_tpu_torch.ops.components import INF

gpu_supported = cuda.gpu_supported


def _neighbor_min(active: torch.Tensor) -> torch.Tensor:
    """Minimum over the 8 neighbours (INF beyond the border)."""
    h, w = active.shape[-2:]
    p = F.pad(active, (1, 1, 1, 1), value=INF)
    best = torch.full_like(active, INF)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                best = torch.minimum(best, p[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return best


def quantize(dist: torch.Tensor, levels: int) -> torch.Tensor:
    return (dist.float() * float(levels - 1)).to(torch.int32).clamp(0, levels - 1)


def marker_watershed_plain(
    dist: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
    levels: int = 64, max_rounds: int = 64,
) -> torch.Tensor:
    """dist (B, H, W) float in [0, 1], markers (B, H, W) int32 (INF =
    unlabeled), mask (B, H, W) bool → labels (B, H, W) int32."""
    q = quantize(dist, levels)
    lbl = torch.where(markers >= INF, INF, markers).to(torch.int32)
    is_marker = lbl < INF
    mask = mask.bool()
    for level in range(levels - 1, -1, -1):
        eligible = mask & (q >= level)
        fresh = is_marker & (q == level)
        for allow_fresh in (False, True):
            base = (q >= level) if allow_fresh else (q >= level) & ~fresh

            def step(l):
                active = torch.where((l < INF) & base, l, INF)
                nb = _neighbor_min(active)
                grow = eligible & (l == INF) & (nb < INF)
                return torch.where(grow, nb, l)

            new = step(lbl)
            changed = bool((new != lbl).any())
            lbl = new
            it = 0
            while changed and it < max_rounds:
                new = step(lbl)
                changed = bool((new != lbl).any())
                lbl = new
                it += 1
    return lbl


def marker_watershed(
    dist: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
    levels: int = 64, max_rounds: int = 64,
) -> torch.Tensor:
    """The flood: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if not dist.is_cuda:
        return marker_watershed_plain(dist, markers, mask, levels, max_rounds)
    b, h, w = dist.shape
    if not 1 <= levels <= 64:
        raise ValueError(f"marker_watershed kernel takes 1..64 levels, got {levels}")
    d = dist.float().contiguous()
    mk = markers.to(torch.int32).contiguous()
    m = mask.contiguous().view(torch.uint8) if mask.dtype == torch.bool else (mask != 0).to(torch.uint8)
    cuda.check(d, "dist", torch.float32, (b, h, w))
    cuda.check(mk, "markers", torch.int32, (b, h, w))
    cuda.check(m, "mask", torch.uint8, (b, h, w))
    out = torch.empty((b, h, w), dtype=torch.int32, device=dist.device)
    scratch = torch.empty_like(out)
    code = torch.empty((b, h, w), dtype=torch.uint8, device=dist.device)
    cuda.launch(
        "flood", "flood_launch",
        cuda.ptr(d), cuda.ptr(mk), cuda.ptr(m), cuda.ptr(out), cuda.ptr(scratch),
        cuda.ptr(code), b, h, w, levels, max_rounds, cuda.stream(),
    )
    marker_watershed.launches += 1
    return out


marker_watershed.launches = 0
