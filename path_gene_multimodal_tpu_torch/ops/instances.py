"""Per-instance features from dense instance label maps, and the sparse
label and feature transport.

Counterpart of the JAX package's ``ops/instances.py``
(``instance_features_batch`` with ``use_pallas=True``,
``instance_contours`` and the sparse transport ``pack_labels_sparse`` ...
``groups_from_sparse``): the segment reduction is K4
(``ops/instance_stats.py``), the features are elementwise on its small
output, and the contours are traced on the host per instance bbox crop.

The packs run on the device without waiting for it: each nonzero entry's
rank is a prefix sum of the mask, and the entries whose rank is within the
budget are scattered to that rank in a zero-filled buffer, so the indices
ascend and the padding is JAX's (index 0); the true count stays a device
scalar. Ids stay int32 (the JAX package narrows them to uint16), and
``groups_from_sparse`` groups on (window, id) for any id.
"""

from __future__ import annotations

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.ops.contours import douglas_peucker, exterior_ring
from path_gene_multimodal_tpu_torch.ops.instance_stats import (
    features_from_stats,
    instance_stats,
    stats_center,
)


def instance_features_batch(
    inst_maps: torch.Tensor, type_maps: torch.Tensor, max_instances: int = 512,
    num_types: int = 6,
) -> dict[str, torch.Tensor]:
    """(B, H, W) dense labels (0 background, ids >= max_instances dropped)
    + (B, H, W) types → per-id arrays (B, max_instances): area,
    centroid_x/y, bbox [xmin, ymin, xmax, ymax] (max exclusive), type
    (majority vote), major/minor axis, eccentricity, orientation."""
    sums, mins = instance_stats(inst_maps, type_maps, max_instances, num_types)
    center = stats_center(inst_maps.shape[1], inst_maps.shape[2])
    return features_from_stats(sums, mins, num_types, center=center)


def instance_contours(
    inst_map: np.ndarray,
    features: dict[str, np.ndarray],
    simplify_tol: float = 0.5,
) -> dict[int, np.ndarray]:
    """Host-side: per-instance exterior contour on the instance's bbox crop
    (reference: longest find_contours + approximate_polygon(tol=0.5),
    aggregated_hovernet_run.py:184-198). Returns {inst_id: (K, 2) [x, y]}."""
    out: dict[int, np.ndarray] = {}
    area = np.asarray(features["area"])
    for inst_id in np.flatnonzero(area > 0):
        if inst_id == 0:
            continue
        inst_id = int(inst_id)
        x0 = int(features["bbox_xmin"][inst_id])
        y0 = int(features["bbox_ymin"][inst_id])
        x1 = int(features["bbox_xmax"][inst_id])
        y1 = int(features["bbox_ymax"][inst_id])
        crop = inst_map[y0:y1, x0:x1] == inst_id
        ring = exterior_ring(crop)
        if ring is None or len(ring) < 3:
            continue
        simp = douglas_peucker(ring, simplify_tol, closed=True)
        if len(simp) < 3:
            # DP collapsed a tiny ring: keep the unsimplified exterior
            simp = ring
        out[inst_id] = np.stack([simp[:, 1] + x0, simp[:, 0] + y0], axis=1)
    return out


def _prefix_pack(mask: torch.Tensor, budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(count, idx) of a flat bool ``mask``: ``count`` the true number of
    set entries (an int32 device scalar), ``idx`` (budget,) int32 the
    positions of the first ``budget`` of them in ascending order, 0 past
    ``count``. Enqueued on the device, with no read back to the host."""
    n = mask.numel()
    rank = torch.cumsum(mask, 0, dtype=torch.int32 if n < 2**31 else torch.int64)
    count = rank[-1].to(torch.int32) if n else torch.zeros((), dtype=torch.int32,
                                                            device=mask.device)
    # entry j of rank r (1-based) goes to slot r - 1; the others, and the
    # entries beyond the budget, to a dump slot past the end
    slot = torch.where(mask & (rank <= budget), rank - 1, budget).to(torch.int64)
    idx = torch.zeros(budget + 1, dtype=torch.int32, device=mask.device)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=mask.device))
    return count, idx[:budget]


def pack_labels_sparse(lbl: torch.Tensor, budget: int):
    """Device-side sparse encoding of dense label maps for a small copy to
    the host (nuclei cover ~1-20% of a window's pixels).

    ``lbl``: (B, H, W) integer labels, 0 = background. Returns
    ``(count, idx, ids)``: ``count`` int32 device scalar = the TRUE number
    of nonzero pixels (may exceed ``budget``); ``idx`` (budget,) int32 flat
    indices into ``lbl.reshape(-1)`` in ascending order; ``ids`` (budget,)
    int32 label values at those pixels. Entries past ``count`` are padding
    (index 0 and the label there). If ``count > budget`` the encoding is
    TRUNCATED to the first ``budget`` pixels: callers must fall back to a
    dense transfer."""
    flat = lbl.reshape(-1)
    count, idx = _prefix_pack(flat != 0, budget)
    return count, idx, flat.index_select(0, idx).to(torch.int32)


def unpack_labels_sparse(count, idx, ids, shape: tuple) -> np.ndarray:
    """Host-side inverse of :func:`pack_labels_sparse` → dense int32."""
    n = int(count)
    out = np.zeros(int(np.prod(shape)), np.int32)
    out[np.asarray(idx[:n])] = np.asarray(ids[:n])
    return out.reshape(shape)


def pack_features_sparse(feats: dict, budget: int):
    """Compact a (B, max_instances)-slotted feature dict to its LIVE slots
    (area > 0) on the device. Returns ``(count, idx, packed)`` with the
    truncation contract of :func:`pack_labels_sparse` (``idx`` flat into
    the (B * max_instances,) slot axis). Only live slots round-trip: dead
    slots unpack to zero, whatever the dense value there (consumers filter
    on ``area > 0`` before reading any key)."""
    count, idx = _prefix_pack(feats["area"].reshape(-1) > 0, budget)
    packed = {k: v.reshape(-1).index_select(0, idx) for k, v in feats.items()}
    return count, idx, packed


def unpack_features_sparse(
    count, idx, packed: dict, batch: int, max_instances: int
) -> dict[str, np.ndarray]:
    """Host-side inverse of :func:`pack_features_sparse` → full
    (batch, max_instances) numpy slot tables."""
    n = int(count)
    sel = np.asarray(idx[:n])
    out = {}
    for k, v in packed.items():
        vn = np.asarray(v)
        full = np.zeros(batch * max_instances, vn.dtype)
        full[sel] = vn[:n]
        out[k] = full.reshape(batch, max_instances)
    return out


def groups_from_sparse(
    count, idx, ids, batch: int, height: int, width: int
) -> list[dict[int, tuple[np.ndarray, np.ndarray]]]:
    """Per-window {id: (ys, xs)} pixel groups straight from a sparse label
    encoding: one vectorized pass over the nonzero pixels. Groups come in
    ascending id, each group's pixels in raster order."""
    n = int(count)
    sel = np.asarray(idx[:n]).astype(np.int64)
    idv = np.asarray(ids[:n]).astype(np.int64)
    hw = height * width
    b = sel // hw
    r = sel % hw
    ys = r // width
    xs = r % width
    # (window, id) as one key, free of collisions for any id >= 0
    key = b * (int(idv.max(initial=0)) + 1) + idv
    order = np.argsort(key, kind="stable")
    key, b, ys, xs, idv = key[order], b[order], ys[order], xs[order], idv[order]
    starts = np.flatnonzero(np.diff(key, prepend=-1))
    out: list[dict[int, tuple[np.ndarray, np.ndarray]]] = [{} for _ in range(batch)]
    for j, lo in enumerate(starts):
        hi = starts[j + 1] if j + 1 < len(starts) else n
        out[int(b[lo])][int(idv[lo])] = (ys[lo:hi], xs[lo:hi])
    return out
