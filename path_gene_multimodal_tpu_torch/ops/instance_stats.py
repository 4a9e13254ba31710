"""K4: per-instance statistics of dense label maps.

Counterpart of the JAX package's ``ops/pallas/instance_stats.py``
(``instance_stats_pallas``, ``stats_center``, ``features_from_stats``). On
CUDA tensors ``instance_stats`` launches ``csrc/instance_stats.cu``; on CPU
tensors it runs ``instance_stats_plain``. Output layout as the TPU
kernel's: sums (B, S, c_sum) f32 with channels [count, sum x, sum y,
sum (x-sx)^2, sum (y-sy)^2, sum (x-sx)(y-sy), votes of types
1..num_types-1, zero padding to a multiple of 8], mins (B, 4, S) f32 rows
[xmin, ymin, -xmax, -ymax] (3e38 for empty slots). Slot 0 carries the
background; ids outside [0, S) are ignored.
"""

from __future__ import annotations

import torch

from path_gene_multimodal_tpu_torch.ops import cuda

_N_FIXED = 6
_BIG = 3e38


def stats_center(h: int, w: int) -> tuple[float, float]:
    """The (sx, sy) the second moments are taken about."""
    return w / 2.0, h / 2.0


def _c_sum(num_types: int) -> int:
    return ((_N_FIXED + num_types - 1 + 7) // 8) * 8


def instance_stats_plain(
    inst_maps: torch.Tensor, type_maps: torch.Tensor, max_instances: int = 512,
    num_types: int = 6,
):
    """Exact integer segment sums (int64), converted to f32 once."""
    b, h, w = inst_maps.shape
    s = max_instances
    dev = inst_maps.device
    lbl = inst_maps.reshape(b, h * w).long()
    tp = type_maps.reshape(b, h * w).long()
    valid = (lbl >= 0) & (lbl < s)
    idx = torch.where(valid, lbl, s)
    pix = torch.arange(h * w, device=dev)
    x = (pix % w).expand(b, -1)
    y = (pix // w).expand(b, -1)
    dx = 2 * x - w
    dy = 2 * y - h
    vals = [torch.ones_like(x), x, y, dx * dx, dy * dy, dx * dy]
    vals += [(tp == t).long() for t in range(1, num_types)]

    def seg_sum(v):
        out = torch.zeros((b, s + 1), dtype=torch.int64, device=dev)
        return out.scatter_add_(1, idx, v.expand(b, -1).contiguous())[:, :s]

    c_sum = _c_sum(num_types)
    sums = torch.zeros((b, s, c_sum), dtype=torch.float32, device=dev)
    for c, v in enumerate(vals):
        t = seg_sum(v)
        sums[..., c] = (t.double() * 0.25).float() if c in (3, 4, 5) else t.float()

    def seg_ext(v, op):
        fill = torch.iinfo(torch.int64).max if op == "amin" else torch.iinfo(torch.int64).min
        out = torch.full((b, s + 1), fill, dtype=torch.int64, device=dev)
        return out.scatter_reduce(1, idx, v.contiguous(), op)[:, :s]

    live = sums[..., 0] > 0
    rows = [seg_ext(x, "amin"), seg_ext(y, "amin"), -seg_ext(x, "amax"), -seg_ext(y, "amax")]
    mins = torch.stack([torch.where(live, r.float(), _BIG) for r in rows], dim=1)
    return sums, mins


def instance_stats(
    inst_maps: torch.Tensor, type_maps: torch.Tensor, max_instances: int = 512,
    num_types: int = 6,
):
    """(B, H, W) dense labels + types → (sums, mins): the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if not inst_maps.is_cuda:
        return instance_stats_plain(inst_maps, type_maps, max_instances, num_types)
    b, h, w = inst_maps.shape
    if not 2 <= num_types <= 9:
        raise ValueError(f"instance_stats kernel takes 2..9 types, got {num_types}")
    smem = cuda.size_query("instance_stats", "instance_stats_smem_bytes", max_instances, num_types)
    if smem > 227 * 1024:
        raise ValueError(f"instance_stats: {max_instances} slots need {smem} B of shared memory")
    lbl = inst_maps.to(torch.int32).contiguous()
    tp = type_maps.to(torch.int32).contiguous()
    cuda.check(lbl, "inst_maps", torch.int32, (b, h, w))
    cuda.check(tp, "type_maps", torch.int32, (b, h, w))
    c_sum = _c_sum(num_types)
    sums = torch.empty((b, max_instances, c_sum), dtype=torch.float32, device=lbl.device)
    mins = torch.empty((b, 4, max_instances), dtype=torch.float32, device=lbl.device)
    cuda.launch(
        "instance_stats", "instance_stats_launch",
        cuda.ptr(lbl), cuda.ptr(tp), cuda.ptr(sums), cuda.ptr(mins), b, h, w,
        max_instances, num_types, c_sum, cuda.stream(),
    )
    instance_stats.launches += 1
    return sums, mins


instance_stats.launches = 0


def features_from_stats(
    sums: torch.Tensor, mins: torch.Tensor, num_types: int,
    center: tuple[float, float] = (0.0, 0.0),
) -> dict[str, torch.Tensor]:
    """(B, S, c_sum) + (B, 4, S) → the ``instance_features_batch`` dict
    (elementwise on the small stats tensors). ``center`` must be the
    ``stats_center`` of the maps the stats came from."""
    sums = sums.clone()
    sums[:, 0, :] = 0.0  # background slot
    area = sums[..., 0]
    safe = torch.clamp(area, min=1.0)
    cx = sums[..., 1] / safe
    cy = sums[..., 2] / safe
    live = area > 0
    cxs, cys = cx - center[0], cy - center[1]
    mu_xx = torch.where(live, sums[..., 3] / safe - cxs * cxs, 0.0)
    mu_yy = torch.where(live, sums[..., 4] / safe - cys * cys, 0.0)
    mu_xy = torch.where(live, sums[..., 5] / safe - cxs * cys, 0.0)
    common = torch.sqrt(torch.clamp(((mu_xx - mu_yy) / 2) ** 2 + mu_xy**2, min=0.0))
    lam1 = torch.clamp((mu_xx + mu_yy) / 2 + common, min=0.0)
    lam2 = torch.clamp((mu_xx + mu_yy) / 2 - common, min=0.0)
    votes = sums[..., _N_FIXED : _N_FIXED + num_types - 1]
    inst_type = torch.where(votes.sum(-1) > 0, votes.argmax(-1) + 1, 0).to(torch.int32)
    z = torch.zeros_like(area)
    return {
        "area": area,
        "centroid_x": torch.where(live, cx, 0.0),
        "centroid_y": torch.where(live, cy, 0.0),
        "bbox_xmin": torch.where(live, mins[:, 0, :], z),
        "bbox_ymin": torch.where(live, mins[:, 1, :], z),
        "bbox_xmax": torch.where(live, -mins[:, 2, :] + 1.0, z),
        "bbox_ymax": torch.where(live, -mins[:, 3, :] + 1.0, z),
        "type": inst_type,
        "major_axis": 4.0 * torch.sqrt(lam1),
        "minor_axis": 4.0 * torch.sqrt(lam2),
        "eccentricity": torch.sqrt(torch.clamp(1.0 - lam2 / torch.clamp(lam1, min=1e-12), min=0.0)),
        "orientation": 0.5 * torch.atan2(2.0 * mu_xy, mu_xx - mu_yy),
    }
