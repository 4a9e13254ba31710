"""Contour extraction: marching squares at level 0.5 + Douglas-Peucker.

A copy of the JAX package's ``ops/contours.py`` (host numpy; the port
imports nothing of the JAX package). Replaces
``skimage.measure.find_contours(mask, 0.5)`` + shapely ``simplify`` in the
reference's nuclei tracing (``aggregated_hovernet_run.py:184-198``).

Semantics notes (deliberate parity with the reference's net behavior):
- Contour vertices sit halfway between foreground and background pixel
  centers (binary mask, level 0.5).
- Saddle cells (two diagonal foreground corners) resolve as *disconnected*,
  matching 4-connected components.
- The reference fills every hole of a traced polygon, so only the
  exterior ring per component is returned (``exterior_ring``;
  ``component_rings`` for every component of a compact label map).
"""
from __future__ import annotations

import numpy as np

# segment table: case → list of (edge_a, edge_b); edges: 0=top 1=right 2=bottom 3=left
_SEGMENTS: dict[int, list[tuple[int, int]]] = {
    0: [], 15: [],
    1: [(3, 2)],
    2: [(2, 1)],
    3: [(3, 1)],
    4: [(0, 1)],
    5: [(0, 1), (3, 2)],   # saddle: bl+tr foreground, disconnected
    6: [(0, 2)],
    7: [(3, 0)],
    8: [(3, 0)],
    9: [(0, 2)],
    10: [(0, 3), (2, 1)],  # saddle: tl+br foreground, disconnected
    11: [(0, 1)],
    12: [(3, 1)],
    13: [(2, 1)],
    14: [(3, 2)],
}


def _edge_point(i: int, j: int, edge: int) -> tuple[float, float]:
    """Midpoint of a cell edge in (row, col) coords; cell (i, j) spans pixel
    centers (i, j)..(i+1, j+1)."""
    if edge == 0:
        return (i, j + 0.5)
    if edge == 1:
        return (i + 0.5, j + 1.0)
    if edge == 2:
        return (i + 1.0, j + 0.5)
    return (i + 0.5, j)


def marching_squares(mask: np.ndarray) -> list[np.ndarray]:
    """All closed contours of a binary mask (level 0.5). The mask is padded
    by one background pixel so border-touching regions yield closed rings.
    Returns list of (K, 2) float arrays in (row, col) of the ORIGINAL mask
    frame (pad offset removed; border rings go to -0.5)."""
    m = np.pad(np.asarray(mask, bool), 1).astype(np.int8)
    h, w = m.shape
    a = m[:-1, :-1]
    b = m[:-1, 1:]
    c = m[1:, 1:]
    d = m[1:, :-1]
    case = (a << 3) | (b << 2) | (c << 1) | d
    ci, cj = np.nonzero((case > 0) & (case < 15))
    # endpoint key: (row*2, col*2) doubled to ints for exact hashing
    seg_map: dict[tuple[int, int], list[tuple[tuple[int, int], int]]] = {}
    segments: list[tuple[tuple[int, int], tuple[int, int]]] = []
    for i, j in zip(ci.tolist(), cj.tolist()):
        for ea, eb in _SEGMENTS[int(case[i, j])]:
            pa = _edge_point(i, j, ea)
            pb = _edge_point(i, j, eb)
            ka = (int(pa[0] * 2), int(pa[1] * 2))
            kb = (int(pb[0] * 2), int(pb[1] * 2))
            idx = len(segments)
            segments.append((ka, kb))
            seg_map.setdefault(ka, []).append((kb, idx))
            seg_map.setdefault(kb, []).append((ka, idx))
    used = np.zeros(len(segments), bool)
    loops: list[np.ndarray] = []
    for start_idx in range(len(segments)):
        if used[start_idx]:
            continue
        ka, kb = segments[start_idx]
        used[start_idx] = True
        loop = [ka, kb]
        cur = kb
        while cur != ka:
            nxt = None
            for cand, sidx in seg_map[cur]:
                if not used[sidx]:
                    used[sidx] = True
                    nxt = cand
                    break
            if nxt is None:
                break  # open chain (shouldn't happen on padded masks)
            loop.append(nxt)
            cur = nxt
        pts = np.array(loop, np.float64) / 2.0 - 1.0  # undo doubling + pad
        loops.append(pts)
    return loops


def ring_area(ring: np.ndarray) -> float:
    """Signed shoelace area of a closed (first==last) or open ring."""
    r = np.asarray(ring, np.float64)
    x, y = r[:, 1], r[:, 0]
    # concatenated rotation beats np.roll's axis plumbing at ~10²-vertex
    # rings called ~10⁴ times per slide; identical arithmetic
    x1 = np.concatenate([x[1:], x[:1]])
    y1 = np.concatenate([y[1:], y[:1]])
    return 0.5 * float(np.sum(x * y1 - x1 * y))


def exterior_ring(mask: np.ndarray) -> np.ndarray | None:
    """The largest-|area| closed contour = the component's exterior ring
    (holes are dropped — the reference's union fills them anyway)."""
    loops = [l for l in marching_squares(mask) if len(l) >= 4]
    if not loops:
        return None
    return max(loops, key=lambda l: abs(ring_area(l)))


def douglas_peucker(points: np.ndarray, tol: float, closed: bool = True) -> np.ndarray:
    """DP polyline simplification (shapely .simplify semantics for rings:
    endpoints anchored; for closed rings the seam is anchored at vertex 0
    and the vertex farthest from it)."""
    pts = np.asarray(points, np.float64)
    if tol <= 0 or len(pts) <= 3:
        return pts
    if closed:
        if np.array_equal(pts[0], pts[-1]):
            pts = pts[:-1]
        if len(pts) <= 3:
            return pts
        far = int(np.argmax(np.sum((pts - pts[0]) ** 2, axis=1)))
        if far == 0:
            return pts
        first = _dp_open(pts[: far + 1], tol)
        second = _dp_open(np.concatenate([pts[far:], pts[:1]], axis=0), tol)
        out = np.concatenate([first[:-1], second[:-1]], axis=0)
        return out
    return _dp_open(pts, tol)


def _dp_open(pts: np.ndarray, tol: float) -> np.ndarray:
    n = len(pts)
    if n <= 2:
        return pts
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        s, e = stack.pop()
        if e <= s + 1:
            continue
        seg = pts[s + 1 : e]
        d0 = pts[e] - pts[s]
        norm = np.hypot(*d0)
        if norm == 0:
            dists = np.sqrt(np.sum((seg - pts[s]) ** 2, axis=1))
        else:
            rel = seg - pts[s]
            dists = np.abs(d0[0] * rel[:, 1] - d0[1] * rel[:, 0]) / norm
        imax = int(np.argmax(dists))
        if dists[imax] > tol:
            k = s + 1 + imax
            keep[k] = True
            stack.append((s, k))
            stack.append((k, e))
    return pts[keep]


def component_rings(lbl: np.ndarray, n: int) -> list[np.ndarray]:
    """Exterior ring per compact label 1..n, traced on each component's
    bbox crop and offset back to mask (row, col) coordinates. Degenerate
    (<3-vertex) components are skipped. Bboxes come from one
    ``scipy.ndimage.find_objects`` pass."""
    from scipy import ndimage

    rings: list[np.ndarray] = []
    for k, sl in enumerate(ndimage.find_objects(lbl, max_label=n), start=1):
        if sl is None:
            continue
        ring = exterior_ring(lbl[sl] == k)
        if ring is None or len(ring) < 3:
            continue
        rings.append(ring + np.asarray([sl[0].start, sl[1].start], dtype=ring.dtype))
    return rings
