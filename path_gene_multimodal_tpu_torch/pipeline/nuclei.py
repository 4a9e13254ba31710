"""Nuclei pipeline: batched HoverNeXt inference + watershed + instance
features + the WSI nuclei table.

Counterpart of the JAX package's ``pipeline/nuclei.py`` (the per-tile
mode, dense transfer):

1. select the TME-ROI tiles of the annotations CSV;
2. read each tile, reflect-pad 224 → 256, batch (threaded); with the
   planar feed (``NucleiConfig.planar_feed``, a reader with
   ``supports_planar``), a chunk crosses to the card as raw 4:2:0 planes
   and ``_planar_seg_prep`` finishes the decode and the reflect pad there;
3. one forward with TTA x4 folded into the batch → NP/HV/TP maps
   (ConvNeXtV2 blocks of stages 0-2 through K1);
4. ``ops.watershed.hover_instances_batch`` → dense instance ids (K2 twice,
   then K3);
   ``RealNucleiModel`` takes the published hover_next layout instead
   (``models/hovernext_real.py``: plain encoder, smp decoders and heads)
   and decodes its instance head through the HoVer route (5 channels) or
   ``ops.watershed.threeclass_instances_batch`` (3 channels), with the
   same kernels;
5. crop to the tile on the device, ``ops.instances.instance_features_batch``
   (K4); labels and features go to the host;
6. rows with tile-local and WSI coordinates, contours, morphology;
   ``<stem>_hovernet_nuclei_wsi.csv`` + ``.parquet``; with
   ``save_tile_artifacts``, per tile ``hovernet_tiles/<x>_<y>/`` with
   ``class_inst.json`` ``{inst_id: [type, [0, cx, cy]]}``, ``pinst_pp.npz``
   and the zarr ``pinst_pp.zip`` (uint32 instance map).

The per-tile mode copies its labels and features to the host dense: its
rows need no pixel groups, and a card's link moves a batch's maps in well
under a millisecond. The sparse transport (``ops/instances.py``), made for
a slow TPU link, is the sliding-window mode's (``pipeline/nuclei_wsi.py``).

Data parallelism: ``NucleiModel.build(..., mesh=)`` and
``RealNucleiModel.build(..., mesh=)`` build one model on each distinct
device of a mesh (``parallel/mesh.py``); each batch is split over the
shards and each shard runs the whole ``segment_async`` (forward, K2, K3)
and, in the per-tile mode, the crop and K4 on its own device, every
shard's work enqueued before anything is read back, the results gathered
in shard order on the mesh's first device. As in the JAX package's mesh
branch there are no collectives, and the planar feed is off.
"""

from __future__ import annotations

import dataclasses
import json
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import pandas as pd
import torch

from path_gene_multimodal_tpu_torch.config import (
    HOVERNEXT_TINY,
    TYPE_NAMES,
    HoverNeXtConfig,
    PipelineConfig,
    RealHoverNeXtConfig,
)
from path_gene_multimodal_tpu_torch.core.artifacts import (
    read_annotations_csv,
    write_nuclei_table,
)
from path_gene_multimodal_tpu_torch.io.slide import SlideReader
from path_gene_multimodal_tpu_torch.io.zarrzip import write_zarr_zip
from path_gene_multimodal_tpu_torch.models import hovernext_real
from path_gene_multimodal_tpu_torch.models.hovernext import (
    HoverNeXt,
    hv_rot_invert,
    init_weights,
    tta_forward,
)
from path_gene_multimodal_tpu_torch.ops import watershed as ws
from path_gene_multimodal_tpu_torch.ops.components import INF
from path_gene_multimodal_tpu_torch.ops.instances import (
    instance_contours,
    instance_features_batch,
)
from path_gene_multimodal_tpu_torch.ops.jpegcolor import ycbcr420_to_rgb
from path_gene_multimodal_tpu_torch.parallel.mesh import Mesh, gather, run_sharded
from path_gene_multimodal_tpu_torch.pipeline.tessellate import decode_chunk_planar
from path_gene_multimodal_tpu_torch.utils.log import get_logger

NUCLEI_COLUMNS = [
    "nuc_id", "inst_id", "type", "type_name", "bounding_box", "centroid",
    "polygon", "tile_name", "tile_path", "tile_x", "tile_y",
    "centroid_x", "centroid_y", "wsi_centroid_x", "wsi_centroid_y",
    "bbox_xmin", "bbox_ymin", "bbox_xmax", "bbox_ymax",
    "wsi_bbox_xmin", "wsi_bbox_ymin", "wsi_bbox_xmax", "wsi_bbox_ymax",
    "wsi_polygon", "area", "perimeter", "eccentricity", "solidity",
    "major_axis_length", "minor_axis_length", "orientation",
]


def load_tile_annotations(csv_path: str | Path) -> pd.DataFrame:
    return read_annotations_csv(csv_path)


def select_tiles_for_hovernet(df: pd.DataFrame) -> pd.DataFrame:
    """in_tme_roi == True, unique by (x, y), sorted (reference :51-70)."""
    sel = df[df["in_tme_roi"] == True]  # noqa: E712
    sel = sel.drop_duplicates(subset=["x", "y"]).sort_values(["y", "x"])
    return sel.reset_index(drop=True)


class _Sharded:
    """The mesh side of both nuclei models: ``mesh`` and one unsharded model
    a distinct mesh device (``replicas``), or None and {}."""

    @classmethod
    def _on_mesh(cls, mesh: Mesh, build_one):
        """The model over ``mesh``: ``build_one(device)`` builds each
        replica (the same weights on each: seeded on the host or from one
        state dict); the first device's replica's fields, its own counter."""
        replicas = {d: build_one(d) for d in mesh.distinct}
        return dataclasses.replace(replicas[mesh.devices[0]], mesh=mesh, replicas=replicas,
                                   _overflow_parts=[])

    def map_shards(self, fn, *batches):
        """``fn(replica, *rows)`` on each shard of the batches with the
        replica on its device, every shard enqueued before anything is read
        back; the outputs gathered in shard order on ``self.device``. Without
        a mesh, ``fn(self, *batches)``."""
        if self.mesh is None:
            return fn(self, *batches)
        outs = run_sharded(self.mesh, lambda dev, *rows: fn(self.replicas[dev], *rows), *batches)
        return gather(outs, self.device)

    def cc_overflow_tiles(self, reset: bool = False) -> int:
        """Tiles (over the batches dispatched so far, on every shard) whose
        component count exceeded the CC slot budget; their extra components
        were dropped."""
        total = int(sum(int(p.sum()) for p in self._overflow_parts))
        if reset:
            self._overflow_parts.clear()
        return total + sum(r.cc_overflow_tiles(reset) for r in self.replicas.values())

    def segment(self, tiles_u8) -> tuple[np.ndarray, np.ndarray]:
        """(B, S, S, 3) uint8 → (instance maps, type maps) int32 numpy."""
        lbl, tp = self.segment_async(torch.as_tensor(np.asarray(tiles_u8)))
        return lbl.cpu().numpy(), tp.cpu().numpy().astype(np.int32)


@dataclass
class NucleiModel(_Sharded):
    """HoverNeXt + post-processing, built once per process on one device
    (or on each device of a mesh)."""

    cfg: HoverNeXtConfig
    model: HoverNeXt
    device: torch.device
    tta: int = 4
    np_threshold: float = 0.5
    marker_threshold: float = 0.4
    max_instances: int = 512
    mesh: Mesh | None = None
    replicas: dict = field(default_factory=dict, repr=False)
    _overflow_parts: list = field(default_factory=list, repr=False)

    @classmethod
    def build(
        cls, cfg: HoverNeXtConfig = HOVERNEXT_TINY, state_dict: dict | None = None,
        seed: int = 0, dtype: torch.dtype = torch.bfloat16, tta: int = 4,
        device: str | torch.device = "cuda", mesh: Mesh | None = None, **kw,
    ) -> "NucleiModel":
        """Random weights from ``seed`` unless ``state_dict`` is given.
        Builds what the JAX package's ``NucleiModel.build`` runs on its
        accelerator: a bf16 model runs the encoder blocks of stages 0-2 as
        K1 and the composite-weight low-res final stage
        (``fused_final="lowres"``), as ``hovernext_forward(...,
        fused_blocks=True)`` does; K1 is bf16 inside, so an f32 model keeps
        plain blocks and the plain resize final stage (JAX's
        ``model.apply``). For another decoder configuration, build the
        ``HoverNeXt`` (``fused_decoder`` / ``fused_final``), call its
        ``fuse()`` and pass it to ``NucleiModel(cfg=..., model=...,
        device=...)``. With a ``mesh``, one such model a distinct device of
        it; ``device`` is then the mesh's first."""
        if mesh is not None:
            return cls._on_mesh(mesh, lambda d: cls.build(cfg, state_dict, seed, dtype, tta,
                                                          device=d, **kw))
        device = torch.device(device)
        fused = dtype == torch.bfloat16
        model = HoverNeXt(cfg, fused_final="lowres" if fused else False, run_on=device)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        model = model.to(device=device, dtype=dtype).eval()
        if fused:
            model.fuse()
        return cls(cfg=cfg, model=model, device=device, tta=tta, **kw)

    @torch.inference_mode()
    def segment_async(self, tiles_u8: torch.Tensor):
        """(B, S, S, 3) uint8 on the device → (labels (B, S, S) int32 dense
        ids, 0 background; types (B, S, S) uint8), enqueued on the current
        stream without waiting for the device (over a mesh: on each shard's
        device, gathered on the first)."""
        if self.mesh is not None:
            return self.map_shards(NucleiModel.segment_async, tiles_u8)
        pixels = tiles_u8.to(self.device, non_blocking=True).float() / 255.0
        out = tta_forward(self.model, pixels, tta=self.tta)
        np_prob = torch.softmax(out["np"], dim=-1)[..., 1]
        tp_cls = out["tp"].argmax(dim=-1).to(torch.uint8)
        lbl, n_over = ws.hover_instances_batch(
            np_prob, out["hv"], np_threshold=self.np_threshold,
            marker_threshold=self.marker_threshold,
        )
        self._overflow_parts.append(n_over)
        return torch.where(lbl < INF, lbl, 0), tp_cls


@dataclass
class RealNucleiModel(_Sharded):
    """The published hover_next layout (``models.hovernext_real.
    RealHoverNeXt``, loaded from a ``pannuke_convnextv2_tiny_3``-style
    checkpoint by ``core.checkpoints.load_hovernext_from_torch``) +
    post-processing, with ``NucleiModel``'s surface (``segment_async``,
    ``segment``, ``cc_overflow_tiles``, ``cfg.input_size``, ``device``,
    ``max_instances``), so both nuclei modes take either. Counterpart of
    the JAX package's ``RealNucleiModel``.

    - The instance branch (the head whose name holds "inst", else the one
      with 3 or 5 channels): with 5 channels, the first 3 are (background,
      interior, border) and the last 2 HV maps, decoded by the HoVer route
      over ``p_interior + p_border`` at ``fg_threshold``; otherwise the
      three-class decoder (``ops.watershed.threeclass_instances_batch``).
    - The type branch: (1 + types) logits a pixel, argmax → type id
      (0 background) as uint8.
    """

    cfg: RealHoverNeXtConfig
    model: hovernext_real.RealHoverNeXt
    device: torch.device
    tta: int = 4
    fg_threshold: float = 0.5
    seed_threshold: float = 0.8
    max_instances: int = 512
    mesh: Mesh | None = None
    replicas: dict = field(default_factory=dict, repr=False)
    _overflow_parts: list = field(default_factory=list, repr=False)

    @classmethod
    def build(
        cls, cfg: RealHoverNeXtConfig, state_dict: dict | None = None, seed: int = 0,
        dtype: torch.dtype = torch.bfloat16, tta: int = 4,
        device: str | torch.device = "cuda", mesh: Mesh | None = None, **kw,
    ) -> "RealNucleiModel":
        """Random weights from ``seed`` unless ``state_dict`` (the port's
        names: ``models.weights_hovernext_real``) is given; loaded strict.
        With a ``mesh``, one model a distinct device of it."""
        if mesh is not None:
            return cls._on_mesh(mesh, lambda d: cls.build(cfg, state_dict, seed, dtype, tta,
                                                          device=d, **kw))
        device = torch.device(device)
        model = hovernext_real.RealHoverNeXt(cfg)
        if state_dict is None:
            hovernext_real.init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        model = model.to(device=device, dtype=dtype).eval()
        return cls(cfg=cfg, model=model, device=device, tta=tta, **kw)

    def __post_init__(self) -> None:
        self.inst_head, self.type_head = _pick_real_branches(self.cfg)
        self.inst_channels = {h: c for _, h, c in self.cfg.branches}[self.inst_head]

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        """Pixels (B, S, S, 3) in [0, 1] → the TTA-averaged head maps."""
        hv = {self.inst_head: (3, 5)} if self.inst_channels == 5 else {}
        return _tta_forward_real(self.model, pixels, tta=self.tta, hv_heads=hv)

    def decode(self, inst_logits: torch.Tensor):
        """The instance head's maps → (labels, overflow), INF background."""
        if self.inst_channels == 5:
            p3 = torch.softmax(inst_logits[..., :3], dim=-1)
            return ws.hover_instances_batch(p3[..., 1] + p3[..., 2], inst_logits[..., 3:5],
                                            np_threshold=self.fg_threshold)
        return ws.threeclass_instances_batch(inst_logits, fg_threshold=self.fg_threshold,
                                             seed_threshold=self.seed_threshold)

    @torch.inference_mode()
    def segment_async(self, tiles_u8: torch.Tensor):
        """(B, S, S, 3) uint8 → (labels (B, S, S) int32 dense ids, 0
        background; types (B, S, S) uint8), enqueued without waiting (over
        a mesh: on each shard's device, gathered on the first)."""
        if self.mesh is not None:
            return self.map_shards(RealNucleiModel.segment_async, tiles_u8)
        pixels = tiles_u8.to(self.device, non_blocking=True).float() / 255.0
        out = self.forward(pixels)
        tp_cls = out[self.type_head].argmax(dim=-1).to(torch.uint8)
        lbl, n_over = self.decode(out[self.inst_head])
        self._overflow_parts.append(n_over)
        return torch.where(lbl < INF, lbl, 0), tp_cls


def _pick_real_branches(cfg: RealHoverNeXtConfig) -> tuple[str, str]:
    """(instance head, type head) of a ``RealHoverNeXtConfig``."""
    heads = [(h, c) for _, h, c in cfg.branches]
    if len(heads) == 1:
        raise ValueError("real hover_next checkpoint has a single branch; "
                         "need instance + type heads")
    inst = [h for h, _ in heads if "inst" in h.lower()]
    if not inst:
        inst = [h for h, c in heads if c in (3, 5)]
    if not inst:
        raise ValueError(f"cannot identify the instance branch among {heads}")
    others = [h for h, _ in heads if h != inst[0]]
    return inst[0], others[0]


def _tta_forward_real(model, pixels: torch.Tensor, tta: int = 4,
                      hv_heads: dict | None = None) -> dict[str, torch.Tensor]:
    """Rotation TTA for a dict-output model whose channels are per-pixel
    class maps, the rotations folded into one forward; ``hv_heads`` marks
    the heads whose channels [lo, hi) hold HV vectors, which take the
    rot-90 sign and swap table (``hv_rot_invert``)."""
    hv_heads = hv_heads or {}
    b = pixels.shape[0]
    stacked = torch.cat([torch.rot90(pixels, k, dims=(1, 2)) for k in range(tta)], dim=0)
    out = model(stacked)

    def invert(name: str, t: torch.Tensor, k: int) -> torch.Tensor:
        t = torch.rot90(t, -k, dims=(1, 2))
        if name in hv_heads:
            lo, hi = hv_heads[name]
            h, v = hv_rot_invert(t[..., lo], t[..., lo + 1], k)
            t = torch.cat([t[..., :lo], torch.stack([h, v], dim=-1), t[..., hi:]], dim=-1)
        return t

    return {name: sum(invert(name, full[k * b : (k + 1) * b], k) for k in range(tta)) / tta
            for name, full in out.items()}


def _pad_tile_to_input(tile: np.ndarray, input_size: int) -> tuple[np.ndarray, int]:
    """Reflect-pad a (T, T, 3) tile to the model input size; returns
    (padded, offset of the tile inside it)."""
    t = tile.shape[0]
    if t == input_size:
        return tile, 0
    pad = (input_size - t) // 2
    out = np.pad(tile, ((pad, input_size - t - pad), (pad, input_size - t - pad), (0, 0)),
                 mode="reflect")
    return out, pad


def _planar_seg_prep(yb: torch.Tensor, cbcr: torch.Tensor, pad_lo: int,
                     pad_hi: int) -> torch.Tensor:
    """Finish a planar 4:2:0 decode and reflect-pad each tile to the model
    input, on the planes' device: (B, S, S, 3) uint8, equal to
    ``_pad_tile_to_input`` of the nearest RGB decode."""
    rgb = ycbcr420_to_rgb(yb, cbcr)
    t = rgb.shape[1]
    if pad_lo == pad_hi == 0:
        return rgb
    idx = np.pad(np.arange(t), (pad_lo, pad_hi), mode="reflect")
    idx = torch.from_numpy(idx).to(rgb.device, non_blocking=True)
    return rgb.index_select(1, idx).index_select(2, idx)


def run_hovernet_pipeline_on_wsi_tiles(
    slide: SlideReader,
    annotations_csv: str | Path,
    out_dir: str | Path,
    stem: str,
    model: NucleiModel,
    cfg: PipelineConfig,
    batch_size: int | None = None,
    save_tile_artifacts: bool = False,
    write_artifacts: bool = True,
) -> pd.DataFrame:
    """The reference's end-to-end nuclei stage (:342-407): returns (and,
    with ``write_artifacts``, writes) the WSI-space nuclei table.
    ``attrs["feed_routes"]`` counts the chunks that took the planar and the
    RGB route."""
    logger = get_logger()
    model.cc_overflow_tiles(reset=True)
    sel = select_tiles_for_hovernet(load_tile_annotations(annotations_csv))
    if len(sel) == 0:
        logger.warning("no TME-ROI tiles for %s; empty nuclei table", stem)
        return _write_empty(out_dir, stem, write_artifacts)

    tile_size = cfg.patch_size
    input_size = model.cfg.input_size
    batch = batch_size or cfg.hovernext.batch_size
    out_dir = Path(out_dir)
    off = (input_size - tile_size) // 2
    rows: list[dict[str, Any]] = []
    capped = {"tiles": 0}
    pinned = model.device.type == "cuda"
    # the planar feed: raw 4:2:0 planes to the card; a chunk it cannot
    # serve (odd coordinates, a tile that is not 4:2:0) is read as RGB
    sharded = getattr(model, "mesh", None) is not None
    planar = (
        cfg.hovernext.planar_feed
        and not sharded  # as in the JAX package's mesh branch
        and tile_size % 2 == 0
        and tile_size <= input_size
        and getattr(slide, "supports_planar", lambda level=0: False)()
    )
    pad_hi = input_size - tile_size - off
    routes = {"planar": 0, "rgb": 0}

    def _pin(t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory() if pinned else t

    def _decode(chunk: np.ndarray):
        if planar:
            planes = decode_chunk_planar(slide, chunk, tile_size, batch)
            if planes is not None:
                return chunk, tuple(_pin(torch.from_numpy(p)) for p in planes)
        tiles = np.zeros((batch, input_size, input_size, 3), np.uint8)
        for i, (x, y) in enumerate(chunk):
            tile = slide.read_region((int(x), int(y)), 0, (tile_size, tile_size))
            tiles[i] = _pad_tile_to_input(tile, input_size)[0]
        return chunk, _pin(torch.from_numpy(tiles))

    def _step(item):
        chunk, tiles = item
        if isinstance(tiles, tuple):
            routes["planar"] += 1
            yb, cbcr = (p.to(model.device, non_blocking=True) for p in tiles)
            tiles = _planar_seg_prep(yb, cbcr, off, pad_hi)
        else:
            routes["rgb"] += 1
        # over a mesh each shard segments, crops and takes its statistics
        li, feats = (model.map_shards(_labels_and_features, tiles) if sharded
                     else _labels_and_features(model, tiles))
        # copies to the host queued behind this batch's work; the event
        # lets _process wait for this batch alone
        host_li = li.to("cpu", non_blocking=pinned)
        host_feats = {k: v.to("cpu", non_blocking=pinned) for k, v in feats.items()}
        done = None
        if pinned:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(model.device))
        return chunk, host_li, host_feats, done

    def _labels_and_features(m, tiles: torch.Tensor):
        lbl, tp = m.segment_async(tiles)
        with torch.inference_mode():
            li = lbl[:, off : off + tile_size, off : off + tile_size].contiguous()
            ti = tp[:, off : off + tile_size, off : off + tile_size].to(torch.int32).contiguous()
            return li, instance_features_batch(li, ti, max_instances=m.max_instances)

    def _process(chunk, host_li, host_feats, done) -> None:
        if done is not None:
            done.synchronize()
        insts = host_li.numpy()[: len(chunk)]
        chunk_feats = {k: v.numpy() for k, v in host_feats.items()}
        capped["tiles"] += int((insts.max(axis=(1, 2), initial=0) >= model.max_instances).sum())
        for bi, (x, y) in enumerate(chunk):
            feats_bi = {k: v[bi] for k, v in chunk_feats.items()}
            rows.extend(_tile_rows(insts[bi], int(x), int(y), out_dir, feats_bi,
                                   save_tile_artifacts))

    coords = sel[["x", "y"]].to_numpy(np.int64)
    chunks = [coords[s : s + batch] for s in range(0, len(coords), batch)]
    pipelined_batches(chunks, _decode, _step, _process)
    n_over = model.cc_overflow_tiles(reset=True)
    if n_over:
        logger.warning("%s: %d tile(s) exceeded the CC slot budget — components beyond "
                       "it were dropped", stem, n_over)
    if capped["tiles"]:
        logger.warning("%s: %d tile(s) had instance ids beyond max_instances=%d — those "
                       "nuclei were dropped", stem, capped["tiles"], model.max_instances)
    nuclei = pd.DataFrame(rows)
    if len(nuclei) == 0:
        nuclei = _write_empty(out_dir, stem, write_artifacts)
    elif write_artifacts:
        write_nuclei_table(out_dir / f"{stem}_hovernet_nuclei_wsi", nuclei)
    nuclei.attrs["cc_slot_overflow_tiles"] = n_over
    nuclei.attrs["feed_routes"] = routes
    return nuclei


def pipelined_batches(chunks, decode_fn, step_fn, process_fn, on_batch=None):
    """Three-stage software pipeline, shared by the per-tile and the
    sliding-window modes: threaded decode (2 workers, 3-deep prefetch) →
    ``step_fn(item)`` (enqueues the batch's device work and its copies to
    the host) → ``process_fn(*args)`` of batch k on the host while batch
    k+1 computes on the device; then ``on_batch(i, args)``, if given."""
    pending = None
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(decode_fn, c) for c in chunks[:3]]
        next_submit = 3
        for i in range(len(chunks)):
            item = futures[i].result()
            futures[i] = None  # release the decoded batch
            if next_submit < len(chunks):
                futures.append(pool.submit(decode_fn, chunks[next_submit]))
                next_submit += 1
            args = step_fn(item)
            if pending is not None:
                process_fn(*pending)
            pending = args
            if on_batch is not None:
                on_batch(i, args)
        if pending is not None:
            process_fn(*pending)


def _tile_rows(inst: np.ndarray, tile_x: int, tile_y: int, out_dir: Path,
               feats: dict[str, np.ndarray],
               save_tile_artifacts: bool = False) -> list[dict[str, Any]]:
    contours = instance_contours(inst, feats, simplify_tol=0.5)
    tile_name = f"{tile_x}_{tile_y}"
    rows = []
    class_inst: dict[str, list] = {}
    for inst_id in np.flatnonzero(np.asarray(feats["area"]) > 0):
        if inst_id == 0:
            continue
        inst_id = int(inst_id)
        t = int(feats["type"][inst_id])
        cx = float(feats["centroid_x"][inst_id])
        cy = float(feats["centroid_y"][inst_id])
        bbox = [
            float(feats["bbox_xmin"][inst_id]), float(feats["bbox_ymin"][inst_id]),
            float(feats["bbox_xmax"][inst_id]), float(feats["bbox_ymax"][inst_id]),
        ]
        poly = contours.get(inst_id)
        area = float(feats["area"][inst_id])
        rows.append({
            "nuc_id": str(uuid.uuid4()),
            "inst_id": inst_id,
            "type": t,
            "type_name": TYPE_NAMES.get(t, "unknown"),
            "bounding_box": bbox,
            "centroid": [cx, cy],
            "polygon": poly.tolist() if poly is not None else [],
            "tile_name": tile_name,
            "tile_path": str(out_dir / "patches" / f"{tile_name}.png"),
            "tile_x": tile_x,
            "tile_y": tile_y,
            "centroid_x": cx,
            "centroid_y": cy,
            "wsi_centroid_x": cx + tile_x,
            "wsi_centroid_y": cy + tile_y,
            "bbox_xmin": bbox[0], "bbox_ymin": bbox[1],
            "bbox_xmax": bbox[2], "bbox_ymax": bbox[3],
            "wsi_bbox_xmin": bbox[0] + tile_x, "wsi_bbox_ymin": bbox[1] + tile_y,
            "wsi_bbox_xmax": bbox[2] + tile_x, "wsi_bbox_ymax": bbox[3] + tile_y,
            "wsi_polygon": (poly + np.array([tile_x, tile_y])).tolist() if poly is not None else [],
            "area": area,
            "perimeter": _ring_length(poly) if poly is not None else 0.0,
            "eccentricity": float(feats["eccentricity"][inst_id]),
            "solidity": _solidity(poly, area) if poly is not None else 1.0,
            "major_axis_length": float(feats["major_axis"][inst_id]),
            "minor_axis_length": float(feats["minor_axis"][inst_id]),
            "orientation": float(feats["orientation"][inst_id]),
        })
        class_inst[str(inst_id)] = [t, [0, cx, cy]]
    if save_tile_artifacts:
        # the reference's layout: <slide dir>/hovernet_tiles/<tile>/
        # (aggregated_hovernet_run.py:376); the zip is its consumers' zarr
        # contract, (1, H, W) uint32 (:163-166 squeeze the leading axis)
        tdir = out_dir / "hovernet_tiles" / tile_name
        tdir.mkdir(parents=True, exist_ok=True)
        (tdir / "class_inst.json").write_text(json.dumps(class_inst))
        np.savez_compressed(tdir / "pinst_pp.npz", inst_map=inst.astype(np.uint32))
        write_zarr_zip(tdir / "pinst_pp.zip", inst.astype(np.uint32)[None])
    return rows


def _ring_length(poly: np.ndarray) -> float:
    d = np.diff(np.concatenate([poly, poly[:1]], axis=0), axis=0)
    return float(np.sum(np.hypot(d[:, 0], d[:, 1])))


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain (tiny per-nucleus point sets)."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out: list[np.ndarray] = []
        for p in seq:
            while len(out) >= 2:
                a, b = out[-1] - out[-2], p - out[-2]
                if a[0] * b[1] - a[1] * b[0] <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    return np.array(half(pts)[:-1] + half(pts[::-1])[:-1])


def _solidity(poly: np.ndarray, area: float) -> float:
    """area / convex-hull area (regionprops solidity)."""
    hull = _convex_hull(poly)
    if len(hull) < 3:
        return 1.0
    x, y = hull[:, 0], hull[:, 1]
    x1 = np.concatenate([x[1:], x[:1]])
    y1 = np.concatenate([y[1:], y[:1]])
    hull_area = 0.5 * abs(np.sum(x * y1 - x1 * y))
    if hull_area <= 0:
        return 1.0
    return float(min(area / hull_area, 1.0))


def _write_empty(out_dir: str | Path, stem: str, write: bool) -> pd.DataFrame:
    """The table's columns with no rows (written when ``write``), so that
    every empty path keeps the schema downstream consumers read."""
    empty = pd.DataFrame(columns=NUCLEI_COLUMNS)
    if write:
        write_nuclei_table(Path(out_dir) / f"{stem}_hovernet_nuclei_wsi", empty)
    return empty
