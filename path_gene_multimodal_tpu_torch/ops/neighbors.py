"""Neighbor search: kNN and radius graphs over nuclei centroids.

Counterpart of the JAX package's ``ops/neighbors.py`` with its routing
rules (the reference's CPU spatial indexing: ``libpysal.KNN.from_array(
coords, k=5)`` notebook cell 11, ``cKDTree.query_ball_tree(r=40µm)``
cells 23-27):

- up to ``HOST_TREE_MAX_N`` points, and for a capped query while n·kk
  stays within ``HOST_TREE_CELL_BUDGET``, the host cKDTree (the
  reference's exact, uncapped ball-query semantics);
- beyond, a chunked dense scan on the card: queries in blocks of
  ``q_chunk``, the points streamed in blocks of ``db_chunk``, a running
  top-k merged per block, so peak memory is q_chunk × (db_chunk + k)
  whatever N is. It caps the radius degree at 256, nearest first.

Distances are diff-based (exact in f32 for 2-D points; the
‖a‖²+‖b‖²-2a·b product loses ~1% on far-from-origin coordinates).

**Ties.** ``jax.lax.top_k`` puts the lower position first among equal
distances; the carried best come before each block and ids ascend within
a block, so the JAX scan orders neighbours by (distance², id).
``torch.topk`` on the card promises no order among ties, so the scan here
ranks one int64 key per candidate, (bits of the f32 distance² << 32) | id,
which has no ties and orders as (distance², id): the same integer indices
as the JAX scan on inputs with ties too. The uint16 index transport the
JAX package added for its TPU link is not needed: indices stay int32 on
the card and cross to the host once.

The device scan runs on the card unless the caller passes
``device="cpu"``; the host routes ignore ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.utils.log import get_logger

_BIG = np.float32(1e30)

# static degree cap on the device radius path (max_degree=None asks for the
# reference's uncapped semantics; above HOST_TREE_MAX_N we must cap — an
# extra probe column detects and WARNS when the cap actually bites)
DEVICE_RADIUS_CAP = 256

# up to this point count the host cKDTree serves every query: the JAX
# package's threshold, which covers its stated production scale (10⁶ nuclei
# per WSI); its measurements were taken on its own host and TPU, not here
HOST_TREE_MAX_N = 2_097_152

# ...but host-tree cost and transients scale with n·kk: an explicitly
# capped query (max_degree=256 → kk=257) at 2M points would allocate
# >10 GB of (n, kk) float64/int64 transients, so wide queries take the
# device scan beyond this n·kk budget (2²⁵ cells)
HOST_TREE_CELL_BUDGET = 1 << 25


def _host_tree(points: np.ndarray):
    try:
        from scipy.spatial import cKDTree
    except ImportError:  # pragma: no cover - scipy absent → device path
        return None
    return cKDTree(points)


def _keys(d2: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(distance², id) as one int64 that orders as the pair: a non-negative
    f32's bits order as its value."""
    return (d2.view(torch.int32).to(torch.int64) << 32) | (ids.to(torch.int64) & 0xFFFFFFFF)


def _unkey(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    ids = (keys & 0xFFFFFFFF).to(torch.int32)  # 0xFFFFFFFF wraps back to -1
    return d2, ids


def _knn_block(
    queries: torch.Tensor, db: torch.Tensor, k: int, db_chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, 2), db (N, 2) padded with +1e9 sentinel rows to a
    ``db_chunk`` multiple → (dist² (Q, k), idx (Q, k)) in (dist², id) order.
    Includes self-matches; the caller filters."""
    dev = queries.device
    best = _keys(torch.full((queries.shape[0], k), _BIG.item(), device=dev),
                 torch.full((queries.shape[0], k), -1, dtype=torch.int32, device=dev))
    qx, qy = queries[:, 0:1], queries[:, 1:2]
    for base in range(0, db.shape[0], db_chunk):
        pts = db[base : base + db_chunk]
        dx = qx - pts[:, 0][None, :]
        dy = qy - pts[:, 1][None, :]
        d2 = dx * dx + dy * dy  # two products and a sum, no fused multiply-add
        ids = torch.arange(base, base + db_chunk, dtype=torch.int32, device=dev)
        cand = torch.cat([best, _keys(d2, ids.expand_as(d2))], dim=1)
        best = torch.topk(cand, k, dim=1, largest=False, sorted=True).values
    return _unkey(best)


def _knn_filtered(
    queries: torch.Tensor,
    db: torch.Tensor,
    n_true: int,
    gid_base: int,
    r2: float | None,
    k: int,
    db_chunk: int,
    drop_self: bool,
) -> torch.Tensor:
    """Neighbor indices (Q, k) with all filtering done on the card: pad/
    sentinel rows, optional self-match drop, optional radius cut; invalid
    slots are -1 and come last, the valid ones in (dist², id) order (the
    JAX package's stable re-sort)."""
    d2, idx = _knn_block(queries, db, k, db_chunk)
    invalid = (idx < 0) | (idx >= n_true) | (d2 >= _BIG.item())
    if drop_self:
        gids = gid_base + torch.arange(queries.shape[0], dtype=torch.int32, device=idx.device)
        invalid |= idx == gids[:, None]
    if r2 is not None:
        invalid |= d2 > torch.tensor(r2, dtype=torch.float32, device=d2.device)
    # valid slots are already in (dist², id) order: a stable partition
    # moves the invalid ones to the end
    order = torch.argsort(invalid.to(torch.uint8), dim=1, stable=True)
    return torch.gather(torch.where(invalid, -1, idx), 1, order)


def _host_or_device_indices(
    pts_np: np.ndarray, n: int, kk: int, q_chunk: int, db_chunk: int,
    drop_self: bool = True, radius=None, device="cuda",
) -> np.ndarray:
    """(N, kk) neighbor indices, nearest-first, -1 invalid (self dropped
    when ``drop_self``, out-of-radius dropped when ``radius``) — host
    cKDTree for small n, chunked device scan otherwise (same contract)."""
    if (
        n <= HOST_TREE_MAX_N
        and n * kk <= HOST_TREE_CELL_BUDGET
        and (tree := _host_tree(pts_np)) is not None
    ):
        d, i = tree.query(pts_np, k=kk, workers=-1)
        d = np.asarray(d, np.float32).reshape(n, -1)
        i = np.asarray(i).reshape(n, -1).astype(np.int32)
        # push self-matches (and scipy's n-index "missing" sentinel) to the
        # end, keeping distance order — the device path's convention
        invalid = i >= n
        if drop_self:
            invalid |= i == np.arange(n)[:, None]
        if radius is not None:
            invalid |= d > radius
        d = np.where(invalid, np.inf, d)
        order = np.argsort(d, axis=1, kind="stable")
        return np.take_along_axis(np.where(invalid, -1, i), order, axis=1)
    return _neighbor_indices(
        pts_np, n, kk, radius, q_chunk, db_chunk, drop_self=drop_self, device=device,
    )


@torch.inference_mode()
def _neighbor_indices(
    pts: np.ndarray, n: int, kk: int, radius, q_chunk: int, db_chunk: int,
    drop_self: bool, device="cuda",
) -> np.ndarray:
    """Host-side driver of the device scan → int32 (N, kk) indices, -1
    invalid. The points go to the card once, padded to a ``db_chunk``
    multiple with +1e9 sentinel rows; the indices come back once."""
    device = torch.device(device)
    r2 = None if radius is None else float(radius) ** 2
    pts_np = np.asarray(pts, np.float32)
    pad_db = (-n) % db_chunk
    db_np = (
        np.concatenate([pts_np, np.full((pad_db, 2), 1e9, np.float32)])
        if pad_db else pts_np
    )
    db = torch.from_numpy(db_np).to(device)
    out = [
        _knn_filtered(db[start : min(start + q_chunk, n)], db, n, start, r2, kk, db_chunk,
                      drop_self)
        for start in range(0, n, q_chunk)
    ]
    return torch.cat(out).cpu().numpy()


def _dists_from_idx(
    pts_np: np.ndarray, idx: np.ndarray, row_chunk: int = 65536
) -> np.ndarray:
    """Recompute Euclidean distances for an (N, K) index matrix host-side
    in row chunks (a full (N, K, 2) broadcast is ~3 GB transient at WSI
    scale, 10⁶ nuclei × cap 256). -1 slots → inf."""
    n = len(idx)
    d = np.empty(idx.shape, np.float32)
    for s in range(0, n, row_chunk):
        blk = idx[s : s + row_chunk]
        diff = pts_np[s : s + row_chunk, None, :] - pts_np[np.maximum(blk, 0)]
        np.sqrt(np.sum(diff * diff, axis=-1, dtype=np.float32), out=d[s : s + row_chunk])
    d[idx < 0] = np.inf
    return d


def _warn_radius_cap(idx: np.ndarray, d: np.ndarray, cap: int, radius: float) -> None:
    """Probe column ``cap`` (requested beyond the emitted slots): a valid
    in-radius entry there means that node has > ``cap`` neighbors and the
    device path dropped edges."""
    if idx.shape[1] <= cap:
        return
    overflow = (idx[:, cap] >= 0) & (d[:, cap] <= radius)
    n_over = int(overflow.sum())
    if n_over:
        get_logger().warning(
            "radius_graph device path: %d/%d nodes exceed the %d-neighbor "
            "degree cap at r=%.1f — edges beyond the cap were dropped "
            "(nearest-first). Pass max_degree to raise the cap or accept it "
            "explicitly; the reference's uncapped ball query is host-only.",
            n_over, len(idx), cap, radius,
        )


def knn(
    points: np.ndarray,
    k: int = 5,
    q_chunk: int = 2048,
    db_chunk: int = 4096,
    include_self: bool = False,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """k nearest neighbors of every point among all points.
    Returns (dists (N, k) float32 Euclidean, indices (N, k) int32)."""
    pts_np = np.asarray(points, np.float32)
    n = len(points)
    if n == 0:  # same empty contract as combined_graphs/radius_graph
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    # never ask for more neighbors than exist (sentinel rows would leak
    # out-of-range indices / ~1e9 distances into the results)
    k = max(min(k, n if include_self else n - 1), 1)
    kk = min(k if include_self else k + 1, n)
    idx = _host_or_device_indices(
        pts_np, n, kk, q_chunk, db_chunk, drop_self=not include_self, device=device,
    )[:, :k]
    # distances recomputed host-side from the coordinates (the same f32
    # diff-based formula the device uses), chunked to bound memory
    d = _dists_from_idx(pts_np, idx)
    return d, idx


def _host_ball_edges(
    tree, pts_np: np.ndarray, radius: float
) -> tuple[np.ndarray, np.ndarray]:
    """UNCAPPED radius edges — the reference's exact ball-query semantics
    (``cKDTree.query_ball_tree(r)``, notebook cells 23-27; both use ≤ r
    and exclude self). ``query_pairs`` returns the unique i<j pairs as one
    ndarray; both directions are emitted to match the ball-query edge
    set."""
    pairs = tree.query_pairs(r=radius, output_type="ndarray")
    if len(pairs) == 0:
        return np.zeros((2, 0), np.int64), np.zeros((0,), np.float32)
    diff = pts_np[pairs[:, 0]] - pts_np[pairs[:, 1]]
    d = np.sqrt(np.sum(diff * diff, axis=-1, dtype=np.float32)).astype(np.float32)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int64)
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int64)
    return np.stack([src, dst], axis=0), np.concatenate([d, d])


def combined_graphs(
    points: np.ndarray,
    k: int = 5,
    radius: float = 160.0,
    max_degree: int | None = None,
    q_chunk: int = 2048,
    db_chunk: int = 4096,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """kNN graph AND radius graph from ONE query (the kNN columns are a
    prefix of the radius candidates). Returns (knn_dists (N, k), knn_idx
    (N, k), edge_index (2, E), edge_dist (E,)) with exactly the
    ``knn``/``radius_graph`` contracts.

    ``max_degree=None`` (default) = UNCAPPED radius edges, the reference's
    exact ball-query semantics — served by the host tree up to
    ``HOST_TREE_MAX_N``; the device path caps at 256 per node,
    nearest-first."""
    pts_np = np.asarray(points, np.float32)
    n = len(points)
    if n == 0:
        return (
            np.zeros((0, k), np.float32), np.zeros((0, k), np.int32),
            np.zeros((2, 0), np.int64), np.zeros((0,), np.float32),
        )
    k = max(min(k, n - 1), 1)
    if max_degree is None and n <= HOST_TREE_MAX_N and (
        tree := _host_tree(pts_np)
    ) is not None:
        # mirrors _host_or_device_indices' invalid-marking + stable-resort
        # convention (inline because this path also needs the query's own
        # distances)
        d_q, i_q = tree.query(pts_np, k=min(k + 1, n), workers=-1)
        d_q = np.asarray(d_q, np.float32).reshape(n, -1)
        i_q = np.asarray(i_q).reshape(n, -1).astype(np.int32)
        invalid = (i_q == np.arange(n)[:, None]) | (i_q >= n)
        d_q = np.where(invalid, np.inf, d_q)
        order = np.argsort(d_q, axis=1, kind="stable")
        i_q = np.take_along_axis(np.where(invalid, -1, i_q), order, axis=1)
        d_q = np.take_along_axis(d_q, order, axis=1)
        knn_i = np.pad(i_q[:, :k], ((0, 0), (0, max(k - i_q.shape[1], 0))),
                       constant_values=-1)
        knn_d = np.pad(d_q[:, :k], ((0, 0), (0, max(k - d_q.shape[1], 0))),
                       constant_values=np.inf).astype(np.float32)
        edge_index, edge_dist = _host_ball_edges(tree, pts_np, radius)
        return knn_d, knn_i, edge_index, edge_dist
    cap = DEVICE_RADIUS_CAP if max_degree is None else max_degree
    # when the caller asked for UNCAPPED semantics, request one probe
    # column past the cap so a silent overflow becomes a logged warning
    probe = 1 if max_degree is None else 0
    kk = min(max(k + 1, cap + 1 + probe), n)
    idx = _host_or_device_indices(pts_np, n, kk, q_chunk, db_chunk, device=device)
    d = _dists_from_idx(pts_np, idx)
    if probe:
        _warn_radius_cap(idx, d, cap, radius)
    knn_d, knn_i = d[:, :k].copy(), idx[:, :k].copy()
    rmask = (idx[:, :cap] >= 0) & (d[:, :cap] <= radius)
    rr, cc = np.nonzero(rmask)
    if len(rr) == 0:
        edge_index = np.zeros((2, 0), np.int64)
        edge_dist = np.zeros((0,), np.float32)
    else:
        edge_index = np.stack(
            [rr.astype(np.int64), idx[rr, cc].astype(np.int64)], axis=0
        )
        edge_dist = d[rr, cc].astype(np.float32)
    return knn_d, knn_i, edge_index, edge_dist


def radius_graph(
    points: np.ndarray,
    radius: float,
    max_degree: int | None = None,
    q_chunk: int = 2048,
    db_chunk: int = 4096,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Edges (i→j) for all pairs within ``radius`` (excluding self).
    Returns (edge_index (2, E) int64, edge_dist (E,) float32) — the
    notebook's cKDTree ball-query contract. ``max_degree=None`` (default)
    = uncapped, exactly the reference's semantics (host tree up to
    ``HOST_TREE_MAX_N``; the device path caps at 256, nearest-first); an
    int caps the degree explicitly."""
    pts_np = np.asarray(points, np.float32)
    n = len(points)
    if n == 0:
        return np.zeros((2, 0), np.int64), np.zeros((0,), np.float32)
    if max_degree is None and n <= HOST_TREE_MAX_N and (
        tree := _host_tree(pts_np)
    ) is not None:
        return _host_ball_edges(tree, pts_np, radius)
    cap = DEVICE_RADIUS_CAP if max_degree is None else max_degree
    probe = 1 if max_degree is None else 0
    idx = _host_or_device_indices(
        pts_np, n, min(cap + 1 + probe, n), q_chunk, db_chunk, radius=radius, device=device,
    )
    if probe and idx.shape[1] > cap:
        # the radius filter already ran on device: a valid probe slot IS
        # an in-radius neighbor beyond the cap
        n_over = int((idx[:, cap] >= 0).sum())
        if n_over:
            get_logger().warning(
                "radius_graph device path: %d/%d nodes exceed the "
                "%d-neighbor degree cap at r=%.1f — edges beyond the cap "
                "were dropped (nearest-first). Pass max_degree to raise "
                "the cap or accept it explicitly.",
                n_over, n, cap, radius,
            )
    idx = idx[:, :cap]
    rr, cc = np.nonzero(idx >= 0)
    if len(rr) == 0:
        return np.zeros((2, 0), np.int64), np.zeros((0,), np.float32)
    src = rr.astype(np.int64)
    dst = idx[rr, cc].astype(np.int64)
    diff = pts_np[src] - pts_np[dst]
    edge_dist = np.sqrt(np.sum(diff * diff, axis=-1, dtype=np.float32))
    return np.stack([src, dst], axis=0), edge_dist.astype(np.float32)
