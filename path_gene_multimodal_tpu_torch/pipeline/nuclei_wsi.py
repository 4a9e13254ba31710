"""Whole-slide HoverNeXt inference — the sliding-window mode.

Counterpart of the JAX package's ``pipeline/nuclei_wsi.py`` (its
single-device path). The reference's canonical WSI configuration
(``hovernet_inference.py`` script body ``:173-209``): window 256, stride
248 (the ``overlap=0.96875`` fraction), batched inference over the window
stream, the windows' instances stitched into one slide-scale uint32
instance map (``<stem>_pinst_pp.npz``, and the zarr ``<stem>_pinst_pp.zip``
the reference's consumers open; sparse coordinates in the npz alone above
``DENSE_MAP_MAX_PIXELS``).

Stitching (steps 1-4 the JAX package's, unchanged):

1. each window is segmented on its own on the device (K1-K3), and its
   instance features are taken there (K4 on the whole window);
2. an instance whose mask does NOT touch a window border (its bbox and
   centroid are exact) is kept by the FIRST window that saw it whole —
   exactly once among clean views;
3. an instance clipped by every window that sees it (it straddles a seam
   wider than the overlap) falls back to stride-cell centroid ownership;
4. a final proximity pass collapses residual seam duplicates (two clipped
   views of one nucleus whose biased centroids landed in different cells),
   keeping the larger fragment;
5. (the port's own) a row whose every pixel a later row claims in the map
   is dropped: a sliver of a nucleus that stops short of its window's
   border (so it reads as clean), under the whole nucleus that the next
   window sees; the JAX package's map would lack its id.

Transport: each batch's labels and live feature slots are packed on the
device (``ops.instances.pack_labels_sparse`` / ``pack_features_sparse``)
and only the packed arrays are copied to the host, behind the batch's
work. A batch whose count exceeds its budget copies the dense tensors,
which stay on the device until its rows are built, and later batches pack
at the next budget of the ladder; the output is the same either way.

With a model over a mesh (``NucleiModel.build(..., mesh=)``) each shard
segments and takes K4 on its own device, and the results, gathered on the
mesh's first device, are packed as above. The planar feed is off, as in
the JAX package's mesh branch.
"""

from __future__ import annotations

import bisect
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.config import PipelineConfig
from path_gene_multimodal_tpu_torch.core.artifacts import savez_fast, write_nuclei_table
from path_gene_multimodal_tpu_torch.io.slide import SlideReader
from path_gene_multimodal_tpu_torch.io.zarrzip import read_zarr_zip, write_zarr_zip
from path_gene_multimodal_tpu_torch.ops.instances import (
    groups_from_sparse,
    instance_features_batch,
    pack_features_sparse,
    pack_labels_sparse,
    unpack_features_sparse,
    unpack_labels_sparse,
)
from path_gene_multimodal_tpu_torch.ops.jpegcolor import ycbcr420_to_rgb
from path_gene_multimodal_tpu_torch.pipeline.nuclei import (
    NucleiModel,
    _tile_rows,
    _write_empty,
    pipelined_batches,
)
from path_gene_multimodal_tpu_torch.pipeline.tessellate import decode_chunk_planar
from path_gene_multimodal_tpu_torch.utils.log import StageRecord, StageTimer, get_logger

#: above this many level-0 pixels the instance map is written sparse
#: (ys/xs/ids arrays) instead of a dense (H, W) uint32 array
DENSE_MAP_MAX_PIXELS = 400_000_000


def iter_windows(
    slide_w: int, slide_h: int, window: int, stride: int
) -> list[tuple[int, int]]:
    """Top-left coords of a stride-grid covering the slide (windows at the
    right/bottom edge are clamped inside)."""
    xs = list(range(0, max(slide_w - window, 0) + 1, stride))
    ys = list(range(0, max(slide_h - window, 0) + 1, stride))
    if xs and xs[-1] + window < slide_w:
        xs.append(slide_w - window)
    if ys and ys[-1] + window < slide_h:
        ys.append(slide_h - window)
    if not xs:
        xs = [0]
    if not ys:
        ys = [0]
    return [(x, y) for y in ys for x in xs]


def contains_1d(lo: float, hi: float, w: int, grid: list[int], window: int) -> bool:
    """1-D window-interior containment of [lo, hi] by the window starting at
    ``w``: strict interior, except the slide-boundary windows may touch the
    outer edge (an instance at the slide edge is not clipped there)."""
    left_ok = lo > w or (w == grid[0] and lo >= w)
    right_ok = hi < w + window or (w == grid[-1] and hi <= w + window)
    return left_ok and right_ok


def axis_candidates(lo: float, hi: float, grid: list[int], window: int) -> list[int]:
    """Ascending window starts whose 1-D interior contains [lo, hi]: the
    strict set is the open interval (hi - window, lo), found by bisection;
    the two boundary windows get their relaxed touch-allowed check."""
    i0 = bisect.bisect_right(grid, hi - window)
    i1 = bisect.bisect_left(grid, lo)
    cand = grid[i0:i1]
    for w in (grid[0], grid[-1]):
        if w not in cand and contains_1d(lo, hi, w, grid, window):
            cand = sorted(set(cand) | {w})
    return cand


def _dedup_seam_duplicates(
    rows: list[dict[str, Any]], radius: float = 32.0
) -> list[dict[str, Any]]:
    """Collapse clipped-view duplicates. Only pairs where at least one
    member is a CLIPPED view (``row["_clipped"]``) are candidates — two
    clean views were already made exactly-once by the containment rule, so
    distinct adjacent nuclei (both clean) are never merged. Duplicate test:
    centroids within ``radius`` AND strictly overlapping WSI bboxes (a
    clipped fragment's bbox is a sub-rectangle of the true nucleus bbox).
    Clean views win over clipped fragments; otherwise the larger area."""
    if len(rows) <= 1:
        return rows
    pts = np.array([[r["wsi_centroid_x"], r["wsi_centroid_y"]] for r in rows])
    boxes = np.array(
        [
            [r["wsi_bbox_xmin"], r["wsi_bbox_ymin"], r["wsi_bbox_xmax"], r["wsi_bbox_ymax"]]
            for r in rows
        ]
    )
    clipped = np.array([bool(r.get("_clipped", False)) for r in rows])
    areas = np.array([r.get("area", 0.0) for r in rows])
    # clean rows first (they must win their nucleus), then by area
    order = np.lexsort((-areas, clipped.astype(int)))
    cell = (pts / radius).astype(np.int64)
    claimed: dict[tuple[int, int], list[int]] = {}
    keep = np.zeros(len(rows), bool)

    def is_dup(i: int, j: int) -> bool:
        if not (clipped[i] or clipped[j]):
            return False  # two clean views are two real nuclei
        if np.hypot(*(pts[i] - pts[j])) > radius:
            return False
        bi, bj = boxes[i], boxes[j]
        return bi[0] < bj[2] and bj[0] < bi[2] and bi[1] < bj[3] and bj[1] < bi[3]

    for i in order:
        cx, cy = cell[i]
        dup = False
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j in claimed.get((cx + dx, cy + dy), ()):
                    if is_dup(i, j):
                        dup = True
                        break
                if dup:
                    break
            if dup:
                break
        if not dup:
            claimed.setdefault((cx, cy), []).append(i)
            keep[i] = True
    return [r for i, r in enumerate(rows) if keep[i]]


def budget_ladders(n_px: int, n_slots: int) -> tuple[list[int], list[int]]:
    """The sparse transport's budgets for a batch of ``n_px`` label pixels
    and ``n_slots`` feature slots: start near the typical nuclei occupancy,
    ×4 per rung (the JAX package's levels), each budget capped at its whole,
    ascending, duplicates dropped — so the ladder only ever rises (the JAX
    package's can fall: at 4 windows × 64 slots its feature ladder is
    [512, 64])."""
    lbl = [max(n_px // 32, 4096), n_px // 8, n_px // 2]
    feat = [max(n_slots // 16, 512), n_slots // 4]
    return (sorted({min(b, n_px) for b in lbl}), sorted({min(b, n_slots) for b in feat}))


def _group_instance_pixels(inst: np.ndarray) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """One pass over a dense window: {id: (ys, xs)}, ids ascending, each
    group's pixels in raster order (what ``groups_from_sparse`` gives)."""
    ys, xs = np.nonzero(inst > 0)
    if len(ys) == 0:
        return {}
    ids = inst[ys, xs]
    order = np.argsort(ids, kind="stable")
    ids, ys, xs = ids[order], ys[order], xs[order]
    uniq = np.unique(ids)
    bounds = np.searchsorted(ids, uniq, side="left")
    out = {}
    for j, uid in enumerate(uniq):
        lo = bounds[j]
        hi = bounds[j + 1] if j + 1 < len(bounds) else len(ids)
        out[int(uid)] = (ys[lo:hi], xs[lo:hi])
    return out


class _DenseFallback:
    """Keeps a batch's dense device tensors alive (not copied) so that an
    overflowing batch can copy them; carries the budgets it was packed
    with."""

    __slots__ = ("lbl", "feats", "lbl_budget", "feat_budget")

    def __init__(self, lbl, feats, lbl_budget, feat_budget):
        self.lbl, self.feats = lbl, feats
        self.lbl_budget, self.feat_budget = lbl_budget, feat_budget


def _paint(pixels: list[tuple[np.ndarray, np.ndarray]], h0: int, w0: int, dense: bool):
    """Paint the kept rows' pixels with ids 1..n in row order (a later row
    overwrites an earlier one where two views overlap) → (the dense (h0, w0)
    uint32 map or None, the sparse map (flat positions, ids) or None, a bool
    per row: hidden, i.e. left with no pixel). Hidden rows are duplicates:
    slivers of a nucleus that stop short of their window's border, so the
    containment test reads them as clean, covered by the whole nucleus a
    later window sees (the JAX package keeps them, and its map then lacks
    their ids). They are taken out, and the ids compacted over the rest."""
    n = len(pixels)
    if dense:
        owner = np.zeros((h0, w0), np.uint32)
        for i, (ys, xs) in enumerate(pixels):
            owner[ys, xs] = i + 1
    else:
        # the last write of each pixel wins, as painting does
        lin = np.concatenate([ys * w0 + xs for ys, xs in pixels] or [np.zeros(0, np.int64)])
        ids = np.concatenate([np.full(len(ys), i + 1, np.uint32)
                              for i, (ys, _) in enumerate(pixels)] or [np.zeros(0, np.uint32)])
        lin, last = np.unique(lin[::-1], return_index=True)
        owner = ids[::-1][last]
    hidden = np.bincount(owner.ravel(), minlength=n + 1)[1:] == 0
    if hidden.any():
        lut = np.zeros(n + 1, np.uint32)
        lut[1:][~hidden] = np.arange(1, int((~hidden).sum()) + 1, dtype=np.uint32)
        owner = lut[owner]
    return (owner, None, hidden) if dense else (None, (lin, owner), hidden)


def _nbytes(*ts) -> int:
    out = 0
    for t in ts:
        for v in (t.values() if isinstance(t, dict) else (t,)):
            out += v.numel() * v.element_size()
    return out


def run_hovernext_wsi(
    slide: SlideReader,
    out_dir: str | Path,
    stem: str,
    model: NucleiModel,
    cfg: PipelineConfig,
    batch_size: int | None = None,
    write_instance_map: bool = True,
    write_artifacts: bool = True,
    timer: StageTimer | None = None,
) -> tuple[Path | None, pd.DataFrame]:
    """Segment the whole slide in sliding windows; returns (the instance
    map's npz path or None, the nuclei table). The table's ``attrs``:
    ``cc_slot_overflow_tiles``, ``feed_routes`` (chunks on the planar and
    the RGB route), ``sparse_budget_levels`` (the ladder rungs the slide
    reached, labels and features), ``hidden_rows_dropped`` (see
    ``_paint``), ``transport`` (bytes copied to the host and batches per
    route) and ``timing`` (seconds waiting on the decode, device ms per
    batch between CUDA events on the card, seconds of host rows, unpacking
    and pixel grouping, stitching and the finalize writes). The table is
    the same with or without ``write_instance_map``."""
    logger = get_logger()
    model.cc_overflow_tiles(reset=True)
    hx = cfg.hovernext
    window = model.cfg.input_size
    stride = int(round(window * hx.overlap))  # 256 * 0.96875 = 248
    batch = batch_size or hx.batch_size
    w0, h0 = slide.level_dimensions[0]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = model.device
    on_card = device.type == "cuda"

    windows = iter_windows(w0, h0, window, stride)
    logger.info("WSI nuclei: %d windows of %d (stride %d) over %dx%d",
                len(windows), window, stride, w0, h0)

    dense_map = write_instance_map and (w0 * h0) <= DENSE_MAP_MAX_PIXELS
    rows: list[dict[str, Any]] = []
    pixels: list[tuple[np.ndarray, np.ndarray]] = []  # per-row (ys, xs) in WSI px
    xs_grid = sorted({x for x, _ in windows})
    ys_grid = sorted({y for _, y in windows})

    def owner(coord: float, grid: list[int]) -> int:
        return grid[min(int(coord // stride), len(grid) - 1)]

    def window_contains(bx0, by0, bx1, by1, wx, wy) -> bool:
        return bx0 > wx and by0 > wy and bx1 < wx + window and by1 < wy + window

    def first_containing_window(bx0, by0, bx1, by1) -> tuple[int, int] | None:
        """Lowest-index window whose interior contains the bbox (computable
        from the grids without running that window)."""
        ys_c = axis_candidates(by0, by1, ys_grid, window)
        if not ys_c:
            return None
        xs_c = axis_candidates(bx0, bx1, xs_grid, window)
        if not xs_c:
            return None
        return (xs_c[0], ys_c[0])

    # the planar feed, per chunk: the slide-edge windows iter_windows clamps
    # inside can sit at odd coordinates, and their chunk takes the RGB route
    sharded = getattr(model, "mesh", None) is not None
    planar = (
        hx.planar_feed
        and not sharded
        and window % 2 == 0
        and getattr(slide, "supports_planar", lambda level=0: False)()
    )
    routes = {"planar": 0, "rgb": 0}

    def _pin(t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory() if on_card else t

    def _decode_chunk(chunk):
        if planar:
            planes = decode_chunk_planar(slide, chunk, window, batch)
            if planes is not None:
                return chunk, tuple(_pin(torch.from_numpy(p)) for p in planes)
        tiles = np.zeros((batch, window, window, 3), np.uint8)
        for i, (x, y) in enumerate(chunk):
            tiles[i] = slide.read_region((x, y), 0, (window, window))
        return chunk, _pin(torch.from_numpy(tiles))

    n_px = batch * window * window
    n_slots = batch * model.max_instances
    lbl_budgets, feat_budgets = budget_ladders(n_px, n_slots)
    pack_level = {"labels": 0, "features": 0}
    transport = {"sparse_bytes": 0, "dense_bytes": 0, "sparse_batches": 0,
                 "dense_label_batches": 0, "dense_feature_batches": 0}
    timing: dict[str, Any] = {"decode_wait_s": 0.0, "device_ms": [], "host_rows_s": 0.0,
                              "unpack_groups_s": 0.0, "stitch_s": 0.0, "finalize_s": 0.0}

    def _warn_cap(inst_max: int) -> None:
        if inst_max >= model.max_instances:
            logger.warning(
                "window batch has >= %d instances; ids beyond the cap are dropped "
                "(raise cfg.hovernext.max_instances_per_tile)", model.max_instances)

    def _to_host(t: torch.Tensor) -> torch.Tensor:
        return t.to("cpu", non_blocking=on_card)

    def _step(item):
        chunk, payload = item
        timing["decode_wait_s"] += time.perf_counter() - clock["last"]
        evs = None
        if on_card:
            evs = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            evs[0].record(torch.cuda.current_stream(device))
        if isinstance(payload, tuple):
            routes["planar"] += 1
            yb, cbcr = (p.to(device, non_blocking=True) for p in payload)
            tiles = ycbcr420_to_rgb(yb, cbcr)
        else:
            routes["rgb"] += 1
            tiles = payload
        lb = lbl_budgets[pack_level["labels"]]
        fb = feat_budgets[pack_level["features"]]
        # over a mesh each shard segments and takes its statistics, the
        # results gathered on the first device
        lbl_dev, feats_dev = (model.map_shards(_labels_and_features, tiles) if sharded
                              else _labels_and_features(model, tiles))
        with torch.inference_mode():
            packed = (*pack_labels_sparse(lbl_dev, lb), *pack_features_sparse(feats_dev, fb))
        # the packed arrays' copies ride behind this batch's work; the dense
        # tensors stay on the device for a refetch
        host = tuple({k: _to_host(v) for k, v in p.items()} if isinstance(p, dict)
                     else _to_host(p) for p in packed)
        if evs is not None:
            evs[1].record(torch.cuda.current_stream(device))
        return chunk, host, evs, _DenseFallback(lbl_dev, feats_dev, lb, fb)

    def _labels_and_features(m, tiles: torch.Tensor):
        lbl, tp = m.segment_async(tiles)
        with torch.inference_mode():
            return lbl, instance_features_batch(lbl.to(torch.int32), tp.to(torch.int32),
                                                max_instances=m.max_instances)

    def _process(chunk, host, evs, fb) -> None:
        if evs is not None:
            evs[1].synchronize()
            timing["device_ms"].append(evs[0].elapsed_time(evs[1]))
        cnt, idx, ids, fcnt, fidx, fpacked = host
        transport["sparse_bytes"] += _nbytes(*host)
        transport["sparse_batches"] += 1
        n = int(cnt)
        t0 = time.perf_counter()
        if n > fb.lbl_budget:  # truncated encoding → dense refetch
            inst_np = fb.lbl.cpu().numpy().astype(np.int32, copy=False)
            transport["dense_bytes"] += _nbytes(fb.lbl)
            transport["dense_label_batches"] += 1
            groups_bw = None
            if pack_level["labels"] < len(lbl_budgets) - 1:
                pack_level["labels"] += 1
                logger.info("sparse label budget %d overflowed (%d px); next batches pack "
                            "at %d", fb.lbl_budget, n, lbl_budgets[pack_level["labels"]])
        else:
            inst_np = unpack_labels_sparse(cnt, idx, ids, (batch, window, window))
            groups_bw = groups_from_sparse(cnt, idx, ids, batch, window, window)
        _warn_cap(int(inst_np.max(initial=0)))
        if int(fcnt) > fb.feat_budget:
            chunk_feats = {k: v.cpu().numpy() for k, v in fb.feats.items()}
            transport["dense_bytes"] += _nbytes(fb.feats)
            transport["dense_feature_batches"] += 1
            if pack_level["features"] < len(feat_budgets) - 1:
                pack_level["features"] += 1
        else:
            chunk_feats = unpack_features_sparse(fcnt, fidx, fpacked, batch, model.max_instances)
        timing["unpack_groups_s"] += time.perf_counter() - t0
        _emit_rows(chunk, inst_np, chunk_feats, groups_bw)

    def _emit_rows(chunk, inst_np, chunk_feats, groups_bw) -> None:
        for bi, (wx, wy) in enumerate(chunk):
            inst = inst_np[bi]
            feats_bi = {k: v[bi] for k, v in chunk_feats.items()}
            t0 = time.perf_counter()
            sub_rows = _tile_rows(inst, wx, wy, out_dir, feats_bi)
            t1 = time.perf_counter()
            timing["host_rows_s"] += t1 - t0
            groups = groups_bw[bi] if groups_bw is not None else _group_instance_pixels(inst)
            for r in sub_rows:
                bx0 = r["wsi_bbox_xmin"]
                by0 = r["wsi_bbox_ymin"]
                bx1 = r["wsi_bbox_xmax"]
                by1 = r["wsi_bbox_ymax"]
                touches_border = not window_contains(bx0, by0, bx1, by1, wx, wy)
                at_slide_edge = bx0 <= 0 or by0 <= 0 or bx1 >= w0 or by1 >= h0
                if not touches_border or at_slide_edge:
                    # clean view: exactly-once via first-containing-window
                    fw = first_containing_window(bx0, by0, bx1, by1)
                    if fw is None and touches_border:
                        # slide-edge nucleus also straddling a seam: every
                        # view is clipped and finds its own (or no) first
                        # window from its biased bbox — take stride-cell
                        # centroid ownership, marked clipped, so the
                        # proximity pass collapses residual duplicates
                        gx, gy = r["wsi_centroid_x"], r["wsi_centroid_y"]
                        if owner(gx, xs_grid) != wx or owner(gy, ys_grid) != wy:
                            continue
                        r["_clipped"] = True
                    else:
                        if fw is not None and fw != (wx, wy):
                            continue
                        r["_clipped"] = touches_border and not at_slide_edge
                else:
                    # clipped in every view → stride-cell centroid ownership
                    gx, gy = r["wsi_centroid_x"], r["wsi_centroid_y"]
                    if owner(gx, xs_grid) != wx or owner(gy, ys_grid) != wy:
                        continue
                    r["_clipped"] = True
                rows.append(r)
                ys, xs = groups.get(r["inst_id"], (np.zeros(0, np.int64),) * 2)
                pixels.append((np.clip(ys + wy, 0, h0 - 1).astype(np.int64),
                               np.clip(xs + wx, 0, w0 - 1).astype(np.int64)))
            timing["stitch_s"] += time.perf_counter() - t1

    chunks = [windows[s : s + batch] for s in range(0, len(windows), batch)]
    # own the stage record (records[-1] during the call would be whatever
    # stage finished before this one: StageTimer appends on context exit)
    rec = None
    if timer is not None:
        rec = StageRecord(name="hovernext_wsi_segment", seconds=0.0)
        timer.records.append(rec)
    t_seg0 = time.perf_counter()
    clock = {"last": t_seg0}

    def _on_batch(i, args):
        if rec is not None:
            rec.items = i * batch + len(args[0])
            rec.seconds = time.perf_counter() - t_seg0
        clock["last"] = time.perf_counter()

    pipelined_batches(chunks, _decode_chunk, _step, _process, on_batch=_on_batch)

    n_over = model.cc_overflow_tiles(reset=True)
    if n_over:
        logger.warning("%s: %d window(s) exceeded the CC slot budget — components beyond it "
                       "were dropped", stem, n_over)
    if rec is not None:
        rec.seconds = time.perf_counter() - t_seg0
        rec.extra = {**(rec.extra or {}), "cc_slot_overflow_tiles": n_over}

    # residual seam duplicates (both views clipped, centroids in different
    # cells): keep the larger fragment
    t0 = time.perf_counter()
    kept = {id(r) for r in _dedup_seam_duplicates(rows)}
    final_rows, final_px = [], []
    for r, px in zip(rows, pixels):
        if id(r) in kept:
            r.pop("_clipped", None)
            final_rows.append(r)
            final_px.append(px)
    inst_map_wsi, sparse_map, hidden = _paint(final_px, h0, w0, dense_map)
    if hidden.any():
        logger.info("%s: %d row(s) whose every pixel a later row claims were dropped (two "
                    "windows segmented one nucleus differently)", stem, int(hidden.sum()))
        final_rows = [r for r, h in zip(final_rows, hidden) if not h]
    for i, r in enumerate(final_rows):
        r["inst_id"] = i + 1
    timing["stitch_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    nuclei = pd.DataFrame(final_rows)
    map_path = None
    if len(nuclei) == 0:
        nuclei = _write_empty(out_dir, stem, write_artifacts)
    elif write_artifacts:
        write_nuclei_table(out_dir / f"{stem}_hovernet_nuclei_wsi", nuclei)
    if write_artifacts and write_instance_map:
        map_path = out_dir / f"{stem}_pinst_pp.npz"
        if inst_map_wsi is not None:
            # the npz and the reference consumers' zarr zip, (1, H, W) uint32
            # (aggregated_hovernet_run.py:163-166, hovernet_plotting.py:44-73),
            # each deflating the whole map: in two threads (zlib releases the
            # GIL)
            with ThreadPoolExecutor(max_workers=2) as wpool:
                fut_npz = wpool.submit(savez_fast, map_path, inst_map=inst_map_wsi)
                fut_zip = wpool.submit(write_zarr_zip, out_dir / f"{stem}_pinst_pp.zip",
                                       inst_map_wsi[None])
                fut_npz.result()
                fut_zip.result()
        else:
            # a map too large to hold dense: its coordinates, npz only
            lin, ids = sparse_map
            savez_fast(map_path, ys=(lin // w0).astype(np.int32),
                       xs=(lin % w0).astype(np.int32), ids=ids,
                       shape=np.asarray([h0, w0], np.int64))
    timing["finalize_s"] = time.perf_counter() - t0
    nuclei.attrs["cc_slot_overflow_tiles"] = n_over
    nuclei.attrs["feed_routes"] = routes
    nuclei.attrs["sparse_budget_levels"] = dict(pack_level)
    nuclei.attrs["hidden_rows_dropped"] = int(hidden.sum())
    nuclei.attrs["transport"] = transport
    nuclei.attrs["timing"] = timing
    logger.info("WSI nuclei: %d instances", len(nuclei))
    return map_path, nuclei


def load_instance_map(path: str | Path) -> np.ndarray:
    """Load a ``<stem>_pinst_pp.npz`` (dense or sparse) or a zarr
    ``pinst_pp.zip`` instance map (squeezed to (H, W) like the reference's
    consumers)."""
    path = Path(path)
    if path.suffix == ".zip":
        arr = read_zarr_zip(path)
        return arr[0] if arr.ndim == 3 and arr.shape[0] == 1 else arr
    with np.load(path) as z:
        if "inst_map" in z:
            return z["inst_map"]
        h, w = z["shape"]
        out = np.zeros((int(h), int(w)), np.uint32)
        out[z["ys"], z["xs"]] = z["ids"]
        return out
