"""Per-instance features from dense instance label maps.

Counterpart of the JAX package's ``ops/instances.py``
(``instance_features_batch`` with ``use_pallas=True``, and
``instance_contours``): the segment reduction is K4
(``ops/instance_stats.py``), the features are elementwise on its small
output, and the contours are traced on the host per instance bbox crop.
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
