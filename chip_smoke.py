"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out DIR]

1. builds every kernel of the port from
   ``path_gene_multimodal_tpu_torch/csrc`` with nvcc (one process per
   source, in parallel) into ``build/kernels/``;
2. drives the nuclei stage the way a user would: ``synthetic_wsi`` →
   ``fit_heads`` on HoverNeXt-tiny → ``NucleiModel.build(HOVERNEXT_TINY,
   tta=4, dtype=bfloat16, device="cuda")`` (K1 blocks and the low-res
   final stage, as the JAX package's accelerator path) →
   ``run_hovernet_pipeline_on_wsi_tiles`` over full batches of 128 tiles,
   with every kernel's launch count set to 0 just before and read just
   after;
2b. drives the chain's embed and graph stages after the nuclei stage, on
   the same slide and 256 tiles, with the kernel counts set to 0 before
   and read after (the chain launches none of them): CLIP ViT-B/16 at its
   published widths (224^2, patch 16, width 768, 12 layers, 12 heads,
   projection 512; seeded weights) as ``ImageEncoder(dtype=bfloat16,
   device="cuda")`` through ``run_extract_features`` at the default batch
   of 512 ((256, 512) finite f32 features; the features H5 is written and
   read back when h5py is installed, decided once and stated in the JSON);
   the bf16 features against the f32 forward on the card (under
   ``exact_f32``) at cosine >= 0.999 per tile, the f32 forward on the card
   against the CPU's on 4 tiles at atol 5e-4 / rtol 1e-3, and a mutant
   (the position embedding left out) that the cosine check must see; the
   forward on 512 tiles timed with CUDA events (second call) beside its
   bound (FLOP from the config at the bf16 peak); ``build_cell_graph`` and
   ``analyze_graph`` over the nuclei table (nodes, kNN and radius edges,
   seconds); ``radius_graph`` with ``max_degree=256`` on 200,000 seeded
   points over a slide-sized extent, which the module routes to the card,
   equal edge for edge to a direct cKDTree query with the same cap,
   nearest first (``_ckdtree_radius_edges``), and timed. Prints a
   ``chain`` JSON line;
3. holds each kernel against its plain PyTorch version on the card, on the
   main path's own inputs at its shapes (K1 with its bias, LN and GRN
   vectors drawn from a seed, in both GELU modes, also at two ragged shapes
   whose H*W is no multiple of its 128-pixel tile, against three mutants:
   GRN gamma = 0, no pw2 bias, the dw input edge-replicated; K2 also at
   slot budgets under which the gated re-run fires and tiles overflow), and
   times kernel, plain version and (where one exists) one PyTorch library
   call computing the same function (for K1 a chain of them); K1's three
   launches are also timed one by one, with their bytes, share of peak and
   ptxas registers and spills, and each is held to its own plain part on
   the kernel's own inputs of that launch, at the stage and ragged shapes
   in both GELU modes (``_k1_parts_check``: a within 1 bf16 ulp + an f32
   slack, y2 within an f32 dot-product bound, the GRN sums within an f32
   sum's, the output of pw2 fed the kernel's own y2 and sums within 1 bf16
   ulp + an f32 slack), each against a mutant its check must see. The f32
   plain versions must give the same result with the caller's TF32 flags
   on as off (``_tf32_scope_check``). K4 is held to its plain version bit
   for bit in both outputs on the batch, at the cluster sizes on either
   side of the one its geometry chooses (timed too), and on cases: 3 x 100
   x 70 (no vector rows), one instance over a whole 224^2 tile, all
   background, ids alternating every pixel, runs of up to 400 pixels over
   lanes and warps (2 x 64 x 1004), whole rows of one id on tiles of
   32-bit sums (2 x 1 x 1500, 1 x 5 x 1025), ids below 0 and at or above
   S, more than 512 instances, 2 and 9 types, 64 slots, B = 1 and 3; three mutants
   of its design must differ (a run piece counted by two lanes, extrema
   from a run's head lane only, a rank's table not merged); a spill in its
   kernel fails the run. K2 and K3 are held to their plain versions
   in every output and in their counts (K2's relaxation passes, K3's
   synchronous steps and pixels grown, summed and per tile) on the batch
   and on ragged cases (K3: 2 x 40 x 56, 3 x 100 x 70 with min-index
   labels over 65,535, two 1 x 100 strips where its 65-step cap binds,
   2 x 512 x 512 whose bit planes do not fit in shared memory; K2:
   3 x 100 x 70, a spiral, a serpentine of 17 passes, staircases that reach
   its 257-pass cap), against mutants that must fail the same check (K3
   updating labels in place, without phase 0's fresh-marker rule, with the
   XLA flood's 64-step cap; K2 combining its column segments one pass
   late); their bounds come from the counted steps and passes, and the
   batch's masks, energy and markers are saved for ``--ab``;
4. checks the slice's output (the kernels' post-processing against the
   plain versions on the same maps; a non-empty, finite nuclei table);
4b. the slide feed from a real file (``_feed``), after the checks of 3
   and 4: the main run's slide written by
   the port's ``io/tiff_write.py`` as a tiled JPEG TIFF (256-px tiles,
   quality 90, 4:2:0, levels /1, /4, /16); the port's tile decoder
   (``csrc/tiledecode.cpp``, host C++ without libjpeg) rebuilt by g++ and
   timed, its link line checked for ``-ljpeg``; on all 576 level-0 tiles
   its fancy RGB equal to PIL's decode bit for bit, its planar form
   finished by ``ycbcr420_to_rgb`` on the card equal to its nearest RGB
   and to the same function on the CPU, and a mutant with Cb and Cr
   swapped that the check must see; one tile split into tables and an
   abbreviated stream, one with a restart interval, one 4:4:4 and one
   progressive (refused, then read by ``TiffTileSlide`` through PIL and
   counted); tiles/s of the three decode forms at all cores and at one
   thread beside PIL at one thread, bytes per tile, and the
   host-to-device copy of a batch of 128, planar and RGB; the nuclei
   stage from the TIFF on the main run's 256 ROI tiles with the planar
   feed (every chunk planar, no decoder refusal, each batch's model input
   byte-equal to the host nearest decode padded by
   ``_pad_tile_to_input``, K1-K4 launched as often as in the main run),
   timed, and once with ``planar_feed`` off; the embed stage from the TIFF
   with the planar feed at batch 512, its features equal to those of the
   RGB feed of the host nearest decode. Prints a ``feed`` JSON line;
4c. the sliding-window WSI mode (``_wsi``) on the same TIFF (written
   again if the feed phase did not leave it): ``run_hovernext_wsi`` over
   its 25 x 25 = 625 windows of 256^2 at stride 248 (4 batches of 128 and
   one of 113; every coordinate even, so every chunk planar), timed, with
   the counts set to 0 just before and read just after (15 K1 calls, 1 K3
   and 1 K4 a batch, K2's 4 a batch plus any adaptive re-run, no K5-K11);
   the map against the table (its ids exactly 1..rows, every row owning
   1..area pixels, the npz equal to the zip, the table finite and inside
   its windows); a second run on the first two chunks (256 windows) whose
   packs are caught by a spy on the module's pack functions: each batch's
   unpacked labels and live feature slots equal the dense device tensors
   copied whole (a mutant pack that drops its last entry must differ), the
   budget rung, the bytes and copy ms of each route, and the host ms of
   ``groups_from_sparse`` against ``_group_instance_pixels``; K4 bit-equal
   to its plain version on the first batch's 256^2 labels at the cluster
   size its geometry chooses, timed there; the CLI
   (``cli.hovernext_infer.main``, in this process) on the 2047 x 2049 crop
   with the most tissue, written as a second TIFF (81 windows, one chunk
   with odd coordinates: the RGB route) with the fitted weights saved as a ``.pt``, in ``--mode
   wsi`` and ``--mode tiles`` (its ROI tiles), each returning 0 and
   writing its CSV and parquet with rows (and the map's npz and zip), beside a
   direct ``run_hovernext_wsi`` call's rows. Prints a ``wsi`` JSON line
   (windows/s beside the per-tile run's tiles/s, the split: decode wait,
   device ms a batch, host rows, unpack and grouping, stitcher, finalize);
5. drives the three decoder configurations of HoverNeXt (``fused_decoder``:
   K7 + K8; ``fused_final="heads"``: K10; ``fused_final="pallas"``: K11)
   through ``run_hovernet_pipeline_on_wsi_tiles`` over one batch of 128
   tiles each, with the counts set to 0 just before each run and read just
   after, holds each configuration's forward against the default's, and
   times each forward by part (encoder / decoder / final stage + heads);
6. holds K7 (its 8 call shapes), K8, K9, K10 and K11 against their plain
   versions on that batch's own activations at full shape, in both GELU
   modes, with biases and LayerNorm vectors drawn from a seed (K11 also
   with a different head block per phase), and runs mutants (a dropped
   bias, LayerNorm scale 1, K7's skip half zeroed, its skip's weights read
   at offset 0, its LayerNorm statistics over half of cout and its input
   edge-replicated, a dropped head bias, K9 in the other GELU mode, K11's
   head blocks applied to the wrong phases) that the check must catch;
   times each kernel, its plain version and cuDNN's conv at the same shape
   (conv only); K7 also at two ragged shapes, with its per-call L2 bytes,
   geometry and ptxas lines (a spill fails the run). K9 and K10
   (``csrc/upsample_conv.cu``) and K8 and K11 (``csrc/conv64.cu``) are also
   checked at shapes whose output is no multiple of their tile or strip,
   and against a mutant that pads the conv's input by edge replication
   instead of zeros; the JSON holds the ptxas registers and spills of
   ``csrc/conv64.cu`` (a spill of K8/K11's kernel fails the run).
   ``fused_final=True``
   (K9) runs through the nuclei stage like the configurations of 5;
   ``fused_final=False`` (the plain resize path) and
   ``lowres_decoder=True`` get forward rows;
7. drives the tissue-boundary / islands path
   (``pipeline/morphology.py::process_one_slide_make_csv_and_plot``) on the
   slide's 2000 x 2000 thumbnail, at ``max_work_dim`` 1024 (K5 on three
   1024^2 masks) and 2048 (three 2048^2 masks, 16 tiles each), with an
   islands GeoJSON written from the slide's own tissue (its mask cut by a
   grid into pieces, their rings in level-0 px), the counts
   set to 0 just before each run and read just after; holds its tissue
   mask against the CPU run of the same path, and K5's launches against
   its calls' drivers (one launch a call that runs its rounds on the card,
   one a round where the host drives, as the kernel counts them);
8. holds K5 against its plain version on the path's three masks, on a
   seeded 2048^2 mask whose lines cross every tile border (connectivity 1
   and 2) and on a spiral where the relaxation caps bind, and K6 on the
   nuclei batch's 128 foreground masks and on seeded masks (connectivity 1
   and 2; at 1 also against K2's labels): labels equal in every pixel,
   relaxation and round counts equal; K6's launches come from one call of
   its entry point on the foreground masks (it has no pipeline caller, as
   in the JAX package). K5's two round drivers as the geometry chooses
   them (the path's masks: one launch for all rounds; the lines mask at
   tile 512: a launch a round, whose flag the host reads), the lines mask
   at tile 1024 (bands in global memory) and tile 128 (256 tiles), the
   device driver on four streams at once (more blocks than the card holds
   ask for a grid barrier together), K6 at 3 x 100 x 70, 2 x 512 x 512
   and 2 x 8 x 12,000 (bands in global memory); each case also checks that
   the kernel ran on clusters of the size ``CcTiling`` names, and the
   path's masks that their bands sat in shared memory. Two mutants of the
   banded design (band records joined a pass late; the band border read
   as background) must fail the check. The JSON holds each K5 launch's
   device time and the host loop's share under both drivers, the cluster
   size the geometry did not choose timed through the core's launcher,
   and ptxas's registers and spills of ``csrc/cc.cu`` (a spill fails the
   run).

Prints the ``chain``, ``feed`` and ``wsi`` JSON lines, the slice's tiles/s, the kernels' JSON
line and the card's name and power limit, then, as the last line,
``{"ok": true, "device": {...}}``.
Any failure exits non-zero. Details go to ``DIR/chip_smoke.json`` (default
``build/chip_smoke/``, which git ignores).

    python3 chip_smoke.py --ab PARENT

times K1 (at the three encoder stage shapes, 512 images), K2, K3 and K4
(on the main path's batch that a main run with the same ``--out`` saved), K5
(the islands path's three masks) and K6 (the batch's foreground), K7
(its 8 call shapes) and K8-K11 (one batch of 4 calls each) of the package
copy whose root is PARENT (e.g. an earlier commit unpacked with ``git
archive``) against this checkout's, in turns
(parent, this, this, parent), each in its own process with its own build,
on seeded inputs, each timed group after the card has idled (1-2 s, its
SM clock and power read then), so that no group inherits the clock and
power state of the one before it; the first run of each version also
holds K1 against its plain version at the stage shapes and at ragged
shapes, K8/K11 on 16 images and K2-K6 on the saved inputs, and (this
checkout) records each of K1's launches against its plain part at stage
0. Prints one JSON line per run and exits non-zero if a run fails.
"""

from __future__ import annotations

import inspect
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # non-tensor f32; also used for the int32 scalar work

SLIDE = dict(width=6144, height=6144, seed=11, n_blobs=6, nuclei_per_blob=3000)
N_TILES = 256  # two full batches of 128
# K1 elementwise tolerance: 2 bf16 ulp of the plain output (its final
# rounding, plus a flipped rounding of an operand of pw1 or pw2) + this
# absolute slack for outputs near zero
K1_ATOL = 4e-3
# (H = W, C) of the first block of encoder stages 0-2 at a 256-px input, and
# K1's ragged shapes (B, H, W, C): H*W no multiple of the 128-pixel tile
K1_STAGES = ((64, 96), (32, 192), (16, 384))
K1_RAGGED = ((3, 13, 11, 96), (2, 5, 7, 384))
# K8's ragged shapes (B, H, W; H a multiple of its 32 rows, W no multiple of
# its 64-column strip) and K9/K10/K11's (B, H, W at half resolution)
K8_RAGGED = ((3, 32, 70), (2, 64, 10))
HALF_RAGGED = ((3, 34, 34), (2, 6, 10))
# (H = W, cx, cs, cout) of K7's 8 calls per forward at a 256-px input, and
# K7's ragged shapes (B, H, W, cx, cs, cout): H or W no multiple of its tile
K7_CALLS = ((16, 768, 384, 384), (16, 384, 0, 384), (32, 384, 192, 192), (32, 192, 0, 192),
            (64, 192, 96, 96), (64, 96, 0, 96), (128, 96, 0, 64), (128, 64, 0, 64))
K7_RAGGED = ((3, 20, 20, 192, 96, 96), (2, 12, 40, 64, 0, 64))
# K9: 2 bf16 ulp + this slack. Its plain version and the kernel differ only
# in the order of f32 sums (errors ~1e-6), so the slack can be small enough
# that the other GELU mode (up to 4.7e-4 apart near x = -2.7) fails the
# check; the bias is drawn around -1 so that many outputs sit there
K9_ATOL = 1e-4
# K7/K8 (and the K10/K11 heads): 2 bf16 ulp + this slack. The kernel and the
# plain version sum the same bf16 products in f32 in other orders, which can
# flip the final rounding; K10/K11 add, per logit, two flipped roundings of
# a GELU output y feeding the head product: 2 ulp(max_c |y[pixel, c]|) *
# max_c |w_head[c, n]|
DEC_ATOL = 1e-3
CHUNK = 128  # images per final-stage call (models.hovernext.FINAL_CHUNK)
# the decoder configurations, and the kernels each adds to the main path
CONFIGS = {
    "fused_decoder": ({"fused_decoder": True}, {"decoder_conv": 8, "final_conv_gelu": 4}),
    "heads": ({"fused_final": "heads"}, {"final_heads": 4}),
    "pallas": ({"fused_final": "pallas"}, {"composite_final_heads": 4}),
    "k9": ({"fused_final": True}, {"upsample_final": 4}),
}
# the chain phase's device-route radius graph: seeded nuclei centroids (um)
# over a slide-sized extent (~96k x 72k px at 0.25 um/px), a fifth spread
# evenly, the rest in 16 Gaussian tissue blobs (sigma 120-600 um) whose
# densest parts hold more than 256 neighbours within the radius
GRAPH_POINTS = 200_000
GRAPH_EXTENT_UM = (24_000.0, 18_000.0)
GRAPH_CAP = 256
# the embed phase's bars: bf16 features against the f32 forward (cosine per
# tile), the f32 forward on the card against the CPU's (elementwise)
EMBED_MIN_COS = 0.999
EMBED_ATOL, EMBED_RTOL = 5e-4, 1e-3
THUMB = (2000, 2000)  # the islands path's thumbnail (the JAX default)
ISLAND_CLASSES = ("Tumor", "TILs", "TLS", "Stroma")  # groups tumor / til / tls, and none


def _sync_time(fn, reps: int, warm: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _queued_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls queued behind a sleep
    kernel: the card runs them back to back, whatever the host's launch
    path costs (for a kernel shorter than its wrapper's host time). Raises
    if enqueueing the calls outlasted the sleep."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host > 0.04:
        raise RuntimeError(f"enqueueing {reps} calls took {host:.3f} s, longer than the sleep")
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes: float, ops: list[tuple[float, float]]) -> tuple[float, str]:
    """Least time: the largest of bytes / HBM rate and each unit's ops /
    its peak (tensor cores and CUDA cores run concurrently)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(n / peak for n, peak in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |t| (8 significant bits)."""
    m, e = torch.frexp(t.float())
    return torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


def _idle(res: dict, key: str, seconds: float = 2.0) -> None:
    """Let the card idle before a timed group, so that each group starts
    from the same clock and power state whatever ran before it, and keep
    the SM clock and power draw read at the group's start under ``key``."""
    torch.cuda.synchronize()
    time.sleep(seconds)
    res.setdefault("clocks", {})[key] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _annotations(slide, tile: int, n: int | None, path: Path) -> Path:
    """The TME-ROI tiles: a tile grid over the slide, in the ROI where at
    least half the tile is tissue (non-background); the first ``n`` of them,
    or all with ``n=None``."""
    import pandas as pd

    lv = slide._levels[0]
    h, w = lv.shape[:2]
    rows = []
    for y in range(0, h - tile + 1, tile):
        for x in range(0, w - tile + 1, tile):
            frac = float((lv[y : y + tile, x : x + tile] != 243).any(-1).mean())
            rows.append({"tile_index": len(rows), "x": x, "y": y,
                         "predicted_class": "tumor", "in_tme_roi": frac > 0.5})
    df = pd.DataFrame(rows)
    roi = df.index[df["in_tme_roi"]]
    n = len(roi) if n is None else n
    if len(roi) < n:
        raise RuntimeError(f"slide has {len(roi)} tissue tiles, need {n}")
    df.loc[roi[n:], "in_tme_roi"] = False
    df.to_csv(path, index=False)
    return path


def _stage_inputs(model, pixels: torch.Tensor) -> list[torch.Tensor]:
    """The inputs of the first block of encoder stages 0-2 (bf16 NHWC)."""
    enc = model.model.encoder
    x = pixels.to(torch.bfloat16)
    out = []
    with torch.inference_mode():
        for s in range(3):
            x = enc.downsample_layers[s](x)
            out.append(x.contiguous())
            x = enc.stages[s](x)
    return out


def _check_weights(blk, seed: int) -> list[torch.Tensor]:
    """The block's kernel-layout weights with every vector drawn from
    ``seed``: the model's GRN starts at zero and its LayerNorm at identity,
    which would hide a wrong GRN or LN affine from the comparison."""
    wts = list(blk.kernel_weights())
    gen = torch.Generator().manual_seed(seed)
    draw = {1: (0.0, 0.1), 2: (1.0, 0.1), 3: (0.0, 0.1), 5: (0.0, 0.1),  # dw/LN/pw1 biases
            6: (0.0, 0.3), 7: (0.0, 0.3), 9: (0.0, 0.1)}  # GRN gamma/beta, pw2 bias
    for i, (mean, std) in draw.items():
        v = mean + std * torch.randn(wts[i].shape, generator=gen)
        wts[i] = v.to(device=wts[i].device, dtype=torch.bfloat16)
    return wts


def _k1_edge_padded(x, dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2, exact_gelu=False):
    """A mutant of K1's plain version: the dw input padded by edge
    replication instead of zeros."""
    import torch.nn.functional as F

    from path_gene_multimodal_tpu_torch.ops import convnext_block as k1

    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    _, h, w, _ = x.shape
    xp = F.pad(f(x).permute(0, 3, 1, 2), (3, 3, 3, 3), mode="replicate").permute(0, 2, 3, 1)
    acc = torch.zeros_like(f(x))
    for dx in range(7):
        for dy in range(7):
            acc = acc + xp[:, dy : dy + h, dx : dx + w, :] * f(dw)[dy, dx]
    y = k1.layer_norm_plain(acc + f(dwb), lng, lnb)
    return k1.pw_plain(x, y, w1, b1, gg, gb, w2, b2, exact_gelu)


def _k1_library(x, wts, exact_gelu=False):
    """The block as a chain of PyTorch calls, bf16 channels-last (the
    library yardstick of K1; the port never calls it): cuDNN's depthwise
    conv, LayerNorm, cuBLAS linear, GELU, GRN as tensor ops, linear, the
    residual add."""
    import torch.nn.functional as F

    dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2 = wts
    c = x.shape[-1]
    wdw = dw.permute(2, 0, 1).unsqueeze(1).contiguous(memory_format=torch.channels_last)
    mode = "none" if exact_gelu else "tanh"

    def run():
        y = F.conv2d(x.permute(0, 3, 1, 2), wdw, dwb, padding=3, groups=c).permute(0, 2, 3, 1)
        y = F.layer_norm(y, (c,), lng, lnb, 1e-6)
        y = F.gelu(F.linear(y, w1.t(), b1), approximate=mode)
        gx = torch.sqrt(y.float().square().sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)).to(y.dtype)
        y = gg * (y * nx) + gb + y
        return x + F.linear(y, w2.t(), b2)

    return run


def _ptxas_entries(log: str) -> dict[str, dict]:
    """Registers, stack and spills per kernel entry from ``-Xptxas -v``."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
    return out


def _k1_ptxas(cuda) -> dict[str, dict]:
    """K1's kernels' ptxas lines by launch (pw2 per N tile)."""
    names = {"dw_ln_kernel": "dw_ln", "pw1_kernel": "pw1", "pw2_kernel": "pw2"}
    res = {}
    for entry, info in _ptxas_entries(cuda.build_log("convnext_block")).items():
        for key, name in names.items():
            if key in entry:
                res[name if name != "pw2" else f"pw2[{entry}]"] = info
    return res


def _k1_check(tag, x, wts, failures, mutants=True) -> dict:
    """K1 against its plain version on x in both GELU modes (elementwise,
    2 bf16 ulp + K1_ATOL) and, with ``mutants``, the mutants the check must
    see: GRN gamma = 0, a dropped pw2 bias, the dw input edge-replicated."""
    from path_gene_multimodal_tpu_torch.ops.convnext_block import (
        convnext_block, convnext_block_plain,
    )

    rec = {"shape": list(x.shape)}
    with torch.inference_mode():
        for exact in (True, False):  # tanh last: its output is the mutants' reference
            got = convnext_block(x, *wts, exact_gelu=exact)
            ref = convnext_block_plain(x, *wts, exact_gelu=exact)
            mode = "erf" if exact else "tanh"
            rec[f"max_abs_err_{mode}"] = float((got.float() - ref.float()).abs().max())
            rec[f"excess_{mode}"] = _excess(got, ref, K1_ATOL)
            if not rec[f"excess_{mode}"] <= 1.0:
                failures.append(f"K1 {tag} ({mode} GELU): |kernel - plain| exceeds "
                                f"2 ulp + {K1_ATOL} by x{rec[f'excess_{mode}']:.3g}")
            del got
        if mutants:
            bads = {}
            for what, i in (("grn_gamma=0", 6), ("no_b2", 9)):
                bad = list(wts)
                bad[i] = torch.zeros_like(wts[i])
                bads[what] = lambda bad=bad: convnext_block_plain(x, *bad)
            bads["dw_edge_padded"] = lambda: _k1_edge_padded(x, *wts)
            for what, fn in bads.items():
                rec[f"excess_if_{what}"] = _excess(fn(), ref, K1_ATOL)
                if rec[f"excess_if_{what}"] <= 1.0:
                    failures.append(f"K1 {tag}: the check does not see {what}")
    return rec


def _k1_launch_times(x, wts, reps: int = 5) -> dict:
    """ms of each of K1's launches on x (CUDA events), its bytes moved and,
    for the products, their share of the bf16 peak."""
    from path_gene_multimodal_tpu_torch.ops.convnext_block import launch_parts

    parts = launch_parts(x, wts)
    geo = parts["tiling"]
    res = {}
    with torch.inference_mode():
        for name in ("dw_ln", "pw1", "pw2"):
            ms = _sync_time(parts[name], reps=reps)
            nbytes = geo.bytes_moved()[name]
            r = {"ms": ms, "bytes": nbytes, "bytes_share_of_peak": nbytes / (ms * 1e-3) / PEAK_BYTES}
            if name in geo.flops():
                r["products_share_of_bf16_peak"] = geo.flops()[name] / (ms * 1e-3) / PEAK_BF16
            res[name] = r
    res["geometry"] = {"dw_grid": geo.dw_grid, "dw_args": list(geo.dw_args()),
                       "pw1_grid": geo.pw1_grid, "pw2_grid": geo.pw2_grid,
                       "launch_args": list(geo.launch_args())}
    del parts
    return res


F32_U = 2.0 ** -24  # f32 unit roundoff


def _k1_kernel_parts(x, wts, exact_gelu):
    """K1's three launches on x, one after the other: the kernel's a (B,
    pixels, C) bf16, y2 (B, pixels, 4C) f32, its per-image sums of squares
    gsum (B, 4C) and the output."""
    from path_gene_multimodal_tpu_torch.ops.convnext_block import launch_parts

    parts = launch_parts(x, wts, exact_gelu=exact_gelu)
    for name in ("dw_ln", "pw1", "pw2"):
        parts[name]()
    torch.cuda.synchronize()
    return parts["buffers"]


def _k1_ln_slack(x, dw, dwb, lng, lnb) -> torch.Tensor:
    """Elementwise bound on how far two f32 LayerNorms of launch 0's input
    may fall apart (beside a flipped bf16 rounding): means over C taken in
    other orders and an rsqrt within a few units move t = (acc - mean) * rs
    by up to u (2C mean|acc| rs + (C + 8) |t|), and the affine's roundings
    add 2u (|t gamma| + |beta|). (B, H, W, C)."""
    from path_gene_multimodal_tpu_torch.ops import convnext_block as k1

    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    c = x.shape[-1]
    acc = k1.dw_plain(x, dw, dwb)
    mu = acc.mean(-1, keepdim=True)
    rs = torch.rsqrt((acc - mu).square().mean(-1, keepdim=True) + 1e-6)
    t = ((acc - mu) * rs).abs()
    t_bound = F32_U * (2 * c * acc.abs().mean(-1, keepdim=True) * rs + (c + 8) * t)
    return f(lng).abs() * t_bound + 2 * F32_U * (t * f(lng).abs() + f(lnb).abs())


def _k1_parts_check(tag, x, wts, exact_gelu, failures, see_unfused=False) -> dict:
    """Each of K1's launches against its own plain part, on the kernel's
    own inputs of that launch, each at a bar tighter than the block's
    end-to-end one (2 bf16 ulp + K1_ATOL), at its own rounding point:

    - launch 0: a within 1 bf16 ulp of bf16(dw_ln_plain) (a flipped
      rounding where the two f32 LayerNorm outputs straddle a bf16 tie) +
      ``_k1_ln_slack`` (a pixel whose mean is far from zero against its
      spread, as deep in the encoder, moves t by many units of itself);
    - launch 1: y2 against ``pw1_plain`` on the kernel's a, within the f32
      bound of a C-term dot product and the GELU's evaluation,
      u (3C + 16) (|a| |w1| + |b1|) elementwise (u = 2^-24);
    - the GRN sums against the f64 sums of the kernel's own y2 squared,
      within u * pixels relatively (an f32 sum of that many positive terms);
    - launch 2: the output against ``pw2_plain`` fed the kernel's own y2
      and sums (so y3 is the kernel's, bit for bit), within 1 bf16 ulp +
      u (8C + 2) (|y3| |w2| + |b2| + |x|).

    Each measure is an excess over its bar (passes at <= 1). Mutants the
    checks must see: the LN bias dropped (launch 0), the pw1 bias dropped
    (launch 1), the sums of bf16-rounded y2 (the sums), the GRN as the plain
    version had it before (an f32 mean of gx in its own order, y3 rounded
    after a separate product and sum) (launch 2).
    The last changes y3 in a few of every 10^5 values; its change of an
    output passes the f32 slack of the bar only where y3 and w2 are large,
    so it is looked for only with ``see_unfused`` (stage 0's 512 images, 2
    x 10^8 outputs; on 8 images it reads 1.4)."""
    from path_gene_multimodal_tpu_torch.ops import convnext_block as k1

    dw, dwb, lng, lnb, w1, b1, gg, gb, w2, b2 = wts
    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    b, h, w, c = x.shape
    mode = "erf" if exact_gelu else "tanh"
    rec: dict = {"shape": list(x.shape), "gelu": mode}
    with torch.inference_mode():
        a_k, y2_k, gsum_k, out_k = _k1_kernel_parts(x, wts, exact_gelu)
        # launch 0
        tol = _k1_ln_slack(x, dw, dwb, lng, lnb).reshape(b, h * w, c)
        a_p = f(k1.dw_ln_plain(x, dw, dwb, lng, lnb)).reshape(b, h * w, c)
        d = (a_k.float() - a_p).abs()
        rec["a_excess"] = float((d / (_bf16_ulp(a_p) + tol)).max())
        rec["a_flips"] = int((d > 0).sum())
        rec["a_elements"] = a_p.numel()
        bad = f(k1.dw_ln_plain(x, dw, dwb, lng, torch.zeros_like(lnb))).reshape(b, h * w, c)
        rec["a_excess_if_no_ln_bias"] = float(((a_k.float() - bad).abs()
                                               / (_bf16_ulp(bad) + tol)).max())
        del bad, tol
        # launch 1
        bound = F32_U * (3 * c + 16) * (a_k.float().abs().reshape(-1, c) @ f(w1).abs()
                                        + f(b1).abs()).reshape(b, h * w, 4 * c)
        y2_p = k1.pw1_plain(a_k, w1, b1, exact_gelu)
        rec["y2_excess"] = float(((y2_k - y2_p).abs() / bound).max())
        rec["y2_max_abs_diff"] = float((y2_k - y2_p).abs().max())
        other = k1.pw1_plain(a_k, w1, torch.zeros_like(b1), exact_gelu)
        rec["y2_excess_if_no_pw1_bias"] = float(((y2_k - other).abs() / bound).max())
        del other, bound
        # the GRN sums
        own = y2_k.double().square().sum(1)
        tol = F32_U * h * w * own + 1e-30
        rec["gsum_excess"] = float(((gsum_k.double() - own).abs() / tol).max())
        rec["gsum_max_rel_diff"] = float(((gsum_k.double() - own).abs() / (own + 1e-30)).max())
        rounded = f(y2_k).double().square().sum(1)
        rec["gsum_excess_if_bf16_y2"] = float(((gsum_k.double() - rounded).abs() / tol).max())
        del own, rounded, tol
        # launch 2, fed the kernel's own y2 and sums
        y3 = k1.grn_plain(y2_k, gsum_k, gg, gb)
        s2 = (y3.reshape(-1, 4 * c).abs() @ f(w2).abs()).reshape(b, h, w, c) + f(b2).abs() \
            + f(x).abs()
        ref2 = k1.pw2_plain(x, y2_k, gsum_k, gg, gb, w2, b2)
        tol2 = _bf16_ulp(ref2) + F32_U * (8 * c + 2) * s2
        rec["out_excess"] = float(((out_k.float() - ref2.float()).abs() / tol2).max())
        rec["out_diffs"] = int((out_k != ref2).sum())
        # the mutant: the GRN as before, an f32 mean of gx and y3 = y2 * scale + beta
        # rounded after a separate product and sum
        gx = torch.sqrt(gsum_k + 1e-12)[:, None, :]
        scale = f(gg) * (gx / (gx.mean(-1, keepdim=True) + 1e-6)) + 1.0
        y3m = f(y2_k * scale + f(gb))
        outm = (f(x) + (y3m.reshape(-1, 4 * c) @ f(w2) + f(b2)).reshape(b, h, w, c)).to(
            torch.bfloat16)
        rec["out_excess_if_unfused_grn"] = float(((out_k.float() - outm.float()).abs()
                                                    / tol2).max())
        rec["y3_diffs_if_unfused_grn"] = int((y3m != y3).sum())
        del y3m, outm, scale, gx, s2, tol2, ref2
        del a_k, y2_k, gsum_k, out_k, a_p, y2_p, y3
    for key in ("a_excess", "y2_excess", "gsum_excess", "out_excess"):
        if not rec[key] <= 1.0:
            failures.append(f"K1 {tag} ({mode} GELU): launch check {key} = {rec[key]:.3g} > 1")
    for key in ("a_excess_if_no_ln_bias", "y2_excess_if_no_pw1_bias", "gsum_excess_if_bf16_y2",
                "out_excess_if_unfused_grn")[: 4 if see_unfused else 3]:
        if not rec[key] > 1.0:
            failures.append(f"K1 {tag} ({mode} GELU): launch check does not see {key}")
    return rec


def _tf32_scope_check(failures) -> dict:
    """The f32 plain versions compute without TF32 whatever the caller's
    global flags: K8's plain version (a cuDNN conv) and K1's pw1 (a cuBLAS
    product), each called with both flags on, equal the same calls with
    them off, and leave the flags as they found them. The same conv and
    product called directly under the flags on are recorded beside them
    (``unscoped_differs``: what the scoping keeps out)."""
    import torch.nn.functional as F

    from path_gene_multimodal_tpu_torch.ops import convnext_block as k1
    from path_gene_multimodal_tpu_torch.ops import decoder as dec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(905)
    rnd = lambda shape, std=1.0: std * torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    x, w, b = rnd((16, 64, 64, 64)), rnd((3, 3, 64, 64), 0.05), rnd(64, 0.1)
    a, w1, b1 = rnd((4096, 96)), rnd((96, 384), 0.1), rnd(384, 0.1)
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    res: dict = {}
    try:
        outs = {}
        for on in (False, True):
            cudnn.allow_tf32 = mm.allow_tf32 = on
            with torch.inference_mode():
                outs[on] = (dec.final_conv_gelu_plain(x, w, b), k1.pw1_plain(a, w1, b1),
                            F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1),
                            a @ w1)
            res[f"flags_kept_{'on' if on else 'off'}"] = (cudnn.allow_tf32, mm.allow_tf32) == (
                on, on)
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved
    res["conv_plain_equal"] = torch.equal(outs[False][0], outs[True][0])
    res["matmul_plain_equal"] = torch.equal(outs[False][1], outs[True][1])
    res["unscoped_differs"] = {"conv": not torch.equal(outs[False][2], outs[True][2]),
                               "matmul": not torch.equal(outs[False][3], outs[True][3])}
    for key in ("conv_plain_equal", "matmul_plain_equal", "flags_kept_off", "flags_kept_on"):
        if not res[key]:
            failures.append(f"TF32 scope: {key} fails")
    return res


def _block_weights(block_cls, c: int, seed: int, dev) -> list[torch.Tensor]:
    """A ``Block(c)`` with every weight drawn from ``seed`` (LN scale around
    1, GRN vectors and biases around 0), bf16 on ``dev``: its
    ``kernel_weights()``, in the layout of the package that defines it."""
    blk = block_cls(c)
    gen = torch.Generator().manual_seed(seed)
    std = {"dwconv.weight": 0.1, "pwconv1.weight": c ** -0.5, "pwconv2.weight": (4 * c) ** -0.5,
           "grn.gamma": 0.3, "grn.beta": 0.3}
    with torch.no_grad():
        for name, prm in blk.named_parameters():
            v = std.get(name, 0.1) * torch.randn(prm.shape, generator=gen)
            prm.copy_(v + (1.0 if name == "norm.weight" else 0.0))
    return list(blk.to(device=dev, dtype=torch.bfloat16).kernel_weights())


def _ab_child(root: Path, check: bool, inputs: Path) -> int:
    """One A/B run: K1, K7 and K8-K11 of the package under ``root``, timed
    on seeded inputs, K2 and K3 on the main path's masks, energy and
    markers saved in ``inputs``, K4 on the batch's labels and types in
    ``k4_inputs.pt`` beside it, and K5 (the islands path's three masks)
    and K6 (the batch's foreground) on those in ``cc_inputs.pt``, with
    ``csrc/cc.cu``'s ptxas lines; with ``check``, K1 held against its plain
    version (and, where the package has its parts, each launch against its
    part at stage 0), K8/K11 on 16 images and K2-K6
    on the saved inputs."""
    sys.path.insert(0, str(root))
    from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY
    from path_gene_multimodal_tpu_torch.models.convnext import Block
    from path_gene_multimodal_tpu_torch.ops import convnext_block as k1
    from path_gene_multimodal_tpu_torch.ops import cuda
    from path_gene_multimodal_tpu_torch.ops import decoder as dec

    if not Path(cuda.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {cuda.__file__}, not the package under {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    bf = torch.bfloat16
    t0 = time.perf_counter()
    cuda.build_all()
    res = {"root": str(root), "build_s": time.perf_counter() - t0, "k1": []}
    if "conv64" in cuda.KERNELS:
        res["ptxas_conv64"] = _ptxas_entries(cuda.build_log("conv64"))
    # the checks here run on seeded weights, not the model's: what exceeds
    # the tolerance is reported for comparing the versions, and fails no run
    # (the contract's checks are the main run's, on the main path's data)
    over: list[str] = []
    gen = torch.Generator().manual_seed(900)
    depths = HOVERNEXT_TINY.encoder.depths
    for s, (hh, c) in enumerate(K1_STAGES):
        x = torch.randn((512, hh, hh, c), generator=gen).to(dev, bf)
        wts = _block_weights(Block, c, 910 + s, dev)
        _idle(res, f"k1_stage{s}")
        with torch.inference_mode():
            ms = _sync_time(lambda: k1.convnext_block(x, *wts), reps=5)
        st = {"shape": list(x.shape), "ms": ms}
        if hasattr(k1, "launch_parts"):
            st["launches"] = _k1_launch_times(x, wts)
        if check:  # the mutants need this checkout's plain version in parts
            st["check"] = _k1_check(f"stage {s}", x, wts, over,
                                    mutants=hasattr(k1, "pw_plain"))
            if s == 0 and hasattr(k1, "pw2_plain"):  # each launch against its part
                st["parts"] = [_k1_parts_check(f"seeded stage {s}", x, wts, exact, over,
                                               see_unfused=True)
                               for exact in (True, False)]
        res["k1"].append(st)
        del x
    res["k1_batch_ms"] = sum(d * st["ms"] for d, st in zip(depths, res["k1"]))
    if check:
        res["ragged"] = []
        for j, (rb, rh, rw, c) in enumerate(K1_RAGGED):
            x = torch.randn((rb, rh, rw, c), generator=gen).to(dev, bf)
            res["ragged"].append(_k1_check(f"{rb}x{rh}x{rw}x{c}", x,
                                           _block_weights(Block, c, 920 + j, dev), over,
                                           mutants=hasattr(k1, "pw_plain")))
        res["ptxas"] = _k1_ptxas(cuda)
    gen_d = torch.Generator(device=dev).manual_seed(901)
    rnd = lambda shape, std=1.0: (  # noqa: E731
        std * torch.randn(shape, generator=gen_d, device=dev)).to(bf)
    res["k7"] = []
    for hh, cx, cs, cout in K7_CALLS:
        x, skip = rnd((512, hh, hh, cx)), rnd((512, hh, hh, cs)) if cs else None
        w7 = rnd((3, 3, cx + cs, cout), (9 * (cx + cs)) ** -0.5)
        vec = [rnd(cout, 0.1), (1 + rnd(cout, 0.1).float()).to(bf), rnd(cout, 0.1)]
        _idle(res, f"k7_{hh}_{cx}_{cs}_{cout}", 1.0)
        with torch.inference_mode():
            res["k7"].append(_sync_time(lambda: dec.decoder_conv(x, skip, w7, *vec), reps=3))
        del x, skip
    res["k7_batch_ms"] = sum(res["k7"])
    x = rnd((512, 128, 128, 64))
    w = rnd((3, 3, 64, 64), 0.05)
    b, bh = rnd(64, 0.1), torch.zeros(10, device=dev, dtype=bf)
    wh = rnd((64, 10), 0.1)
    wc, b4, bh4 = rnd((3, 3, 64, 256), 0.05), rnd(256, 0.1), rnd(40, 0.1)
    wh_bd = torch.block_diag(*[rnd((64, 10), 0.1) for _ in range(4)]).contiguous()
    # a head built block-diagonal needs no device check per call, where the
    # wrapper can skip it
    k11_kw = ({"block_diagonal": True} if "block_diagonal"
              in inspect.signature(dec.composite_final_heads).parameters else {})
    with torch.inference_mode():
        _idle(res, "k9")
        res["k9_batch_ms"] = _sync_time(
            lambda: [dec.upsample_final(c_, w, b) for c_ in x.split(CHUNK)], reps=2)
        _idle(res, "k10")
        res["k10_batch_ms"] = _sync_time(
            lambda: [dec.final_heads(c_, w, b, wh, bh) for c_ in x.split(CHUNK)], reps=2)
        _idle(res, "k11")
        res["k11_batch_ms"] = _sync_time(
            lambda: [dec.composite_final_heads(c_, wc, b4, wh_bd, bh4, **k11_kw)
                     for c_ in x.split(CHUNK)], reps=2)
        if check:  # tolerance as the main run's head checks
            got = dec.composite_final_heads(x[:16], wc, b4, wh_bd, bh4)
            ref = dec.composite_final_heads_plain(x[:16], wc, b4, wh_bd, bh4)
            y = dec.final_conv_gelu_plain(x[:16], wc, b4).float()
            atol = (DEC_ATOL + 2 * _bf16_ulp(y.abs().amax(-1, keepdim=True))
                    * wh_bd.float().abs().amax(0))
            res["k11_excess"] = _excess(got, ref, atol)
        del x
        x8 = rnd((512, 256, 256, 64))
        _idle(res, "k8")
        res["k8_batch_ms"] = _sync_time(
            lambda: [dec.final_conv_gelu(c_, w, b) for c_ in x8.split(CHUNK)], reps=2)
        if check:
            got = dec.final_conv_gelu(x8[:16], w, b)
            res["k8_excess"] = _excess(got, dec.final_conv_gelu_plain(x8[:16], w, b), DEC_ATOL)
        del x8
    from path_gene_multimodal_tpu_torch.ops import cc_sizes as k2
    from path_gene_multimodal_tpu_torch.ops import flood as k3

    t = {k: v.to(dev) for k, v in torch.load(inputs).items()}
    fg, mmask, dist, markers, blb = (t[k] for k in ("fg", "mmask", "dist", "markers", "blb"))
    with torch.inference_mode():
        _idle(res, "k2")
        res["k2_batch_ms"] = _sync_time(lambda: (k2.cc_sizes_adaptive(fg),
                                                 k2.cc_sizes_adaptive(mmask, min_size=3)), reps=10)
        _idle(res, "k3")
        res["k3_batch_ms"] = _sync_time(lambda: k3.marker_watershed(dist, markers, blb), reps=5)
        if check:  # integers: any difference is a fault
            res["k2_diff"] = sum(
                int((a.long() != p.long()).sum())
                for m, ms_ in ((fg, 0), (mmask, 3))
                for a, p in zip(k2.cc_sizes_adaptive(m, min_size=ms_),
                                k2.cc_sizes_adaptive_plain(m, min_size=ms_)))
            res["k3_diff"] = int((k3.marker_watershed(dist, markers, blb)
                                  != k3.marker_watershed_plain(dist, markers, blb)).sum())
    k4_inputs = inputs.parent / "k4_inputs.pt"
    if k4_inputs.exists():  # K4 on the batch's cropped labels and types
        from path_gene_multimodal_tpu_torch.ops import instance_stats as k4

        t = torch.load(k4_inputs)
        li, ti, slots = t["li"].to(dev), t["ti"].to(dev), t["slots"]
        with torch.inference_mode():
            _idle(res, "k4")
            res["k4_batch_ms"] = _sync_time(lambda: k4.instance_stats(li, ti, slots), reps=50)
            _idle(res, "k4_queued")
            res["k4_device_ms"] = _queued_ms(lambda: k4.instance_stats(li, ti, slots), reps=50)
            if check:
                res["k4_diff"] = sum(int((a != p).sum()) for a, p in zip(
                    k4.instance_stats(li, ti, slots), k4.instance_stats_plain(li, ti, slots)))
        del li, ti
    cc_inputs = inputs.parent / "cc_inputs.pt"
    if cc_inputs.exists():  # K5 on the islands path's masks, K6 on the batch's foreground
        from path_gene_multimodal_tpu_torch.ops import cc

        t = torch.load(cc_inputs)
        path_masks, fg6 = [m.to(dev) for m in t["path_masks"]], t["fg"].to(dev)
        res["ptxas_cc"] = _ptxas_entries(cuda.build_log("cc"))
        with torch.inference_mode():
            _idle(res, "k5")
            res["k5_slide_ms"] = _sync_time(
                lambda: [cc.label_components_tiled(m) for m in path_masks], reps=10)
            res["k5_call_ms"] = [_sync_time(lambda: cc.label_components_tiled(m), reps=10)
                                 for m in path_masks]
            _idle(res, "k6")
            res["k6_ms"] = _sync_time(lambda: cc.label_components_batch(fg6), reps=10)
            if check:
                res["k5_diff"] = sum(int((cc.label_components_tiled(m)
                                          != cc.label_components_tiled_plain(m)).sum())
                                     for m in path_masks)
                res["k6_diff"] = int((cc.label_components_batch(fg6)
                                      != cc.label_components_batch_plain(fg6)).sum())
    for k in ("k8_excess", "k11_excess"):
        if res.get(k, 0.0) > 1.0:
            over.append(f"{k} {res[k]:.3g}")
    for k in ("k2_diff", "k3_diff", "k4_diff", "k5_diff", "k6_diff"):
        if res.get(k, 0):
            over.append(f"{k} {res[k]}")
    res["checks_over_tolerance"] = over
    print(json.dumps(res), flush=True)
    return 0


AB_KEYS = ("k1_batch_ms", "k2_batch_ms", "k3_batch_ms", "k4_batch_ms", "k4_device_ms",
           "k5_slide_ms", "k6_ms",
           "k7_batch_ms", "k8_batch_ms", "k9_batch_ms", "k10_batch_ms", "k11_batch_ms")


def _ab(parent: Path, out_dir: Path) -> int:
    """Parent, this checkout, this checkout, parent: one process each, the
    first of each version also checked; all results to ``out_dir/ab.json``.
    K2-K6 run on the inputs that a main run with the same ``--out`` saved
    (``k23_inputs.pt``, ``k4_inputs.pt``, ``cc_inputs.pt``)."""
    inputs = out_dir / "k23_inputs.pt"
    if not inputs.exists():
        print(f"chip_smoke --ab: {inputs} is missing; run chip_smoke.py --out {out_dir} first",
              file=sys.stderr)
        return 1
    runs, rc = [], 0
    order = [(parent, True), (ROOT, True), (ROOT, False), (parent, False)]
    for i, (root, check) in enumerate(order):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--ab-child", str(root),
               "--inputs", str(inputs)]
        proc = subprocess.run(cmd + (["--check"] if check else []), capture_output=True,
                              text=True, timeout=900)
        line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("{")), None)
        if proc.returncode or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            rc = 1
        runs.append({"root": str(root), "rc": proc.returncode,
                     "result": json.loads(line) if line else None})
        r = runs[-1]["result"] or {}
        print(json.dumps({"root": str(root), "rc": proc.returncode,
                          **{k: r.get(k) for k in AB_KEYS + ("checks_over_tolerance",)}}),
              flush=True)
    print(_smi())
    summary = {r["root"] + f"#{i}": {k: r["result"].get(k) for k in AB_KEYS}
               for i, r in enumerate(runs) if r["result"]}
    print(json.dumps({"ab": summary}))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "ab.json").write_text(json.dumps({"smi": _smi(), "runs": runs}, indent=1))
    return rc


def _excess(got: torch.Tensor, ref: torch.Tensor, atol: float) -> float:
    """max |got - ref| / (2 bf16 ulp(|ref|) + atol), elementwise; the check
    passes at <= 1."""
    tol = 2 * _bf16_ulp(ref) + atol
    return float(((got.float() - ref.float()).abs() / tol).max())


def _seeded(like: torch.Tensor, seed: int, mean: float = 0.0, std: float = 0.1) -> torch.Tensor:
    """A vector of ``like``'s shape, device and dtype drawn from ``seed``."""
    v = mean + std * torch.randn(like.shape, generator=torch.Generator().manual_seed(seed))
    return v.to(device=like.device, dtype=like.dtype)


def _table_failures(nuclei, patch: int, what: str) -> list[str]:
    """A nuclei table must be non-empty, finite, and inside its tiles."""
    if len(nuclei) == 0:
        return [f"{what}: empty nuclei table"]
    out = []
    num = nuclei[["centroid_x", "centroid_y", "area", "eccentricity", "major_axis_length"]]
    if not np.isfinite(num.to_numpy(np.float64)).all():
        out.append(f"{what}: non-finite values in the nuclei table")
    if not ((nuclei["centroid_x"].between(0, patch)) & (nuclei["centroid_y"].between(0, patch))
            & (nuclei["area"] > 0)).all():
        out.append(f"{what}: nuclei outside their tile or of zero area")
    return out


def _vit_flops(cfg, images: int) -> float:
    """FLOP (2 per multiply-add) of the tower's products for ``images``
    tiles: the patch embed, per layer the fused QKV, QK^T, PV, the output
    and both MLP products, and the projection."""
    n, d, g, p = cfg.seq_len, cfg.width, cfg.grid, cfg.patch_size
    hidden = int(d * cfg.mlp_ratio)
    macs = g * g * 3 * p * p * d + d * (cfg.out_dim or 0)
    macs += cfg.layers * (4 * n * d * d + 2 * n * n * d + 2 * n * d * hidden)
    return 2.0 * macs * images


def _graph_points(seed: int = 21) -> np.ndarray:
    """GRAPH_POINTS seeded centroids (um, f32) over GRAPH_EXTENT_UM."""
    rng = np.random.default_rng(seed)
    w, h = GRAPH_EXTENT_UM
    n_even = GRAPH_POINTS // 5
    centres = rng.uniform((0.1 * w, 0.1 * h), (0.9 * w, 0.9 * h), (16, 2))
    sigmas = rng.uniform(120.0, 600.0, 16)
    blob = rng.integers(0, 16, GRAPH_POINTS - n_even)
    pts = np.concatenate([rng.uniform((0, 0), (w, h), (n_even, 2)),
                          centres[blob] + rng.normal(size=(len(blob), 2)) * sigmas[blob, None]])
    return np.clip(pts, 0, (w, h)).astype(np.float32)


def _ckdtree_radius_edges(pts: np.ndarray, radius: float, cap: int, slack: int = 16):
    """The device route's radius-graph contract from a direct cKDTree query:
    each point's neighbours within ``radius`` (self excluded), nearest
    first, the first ``cap`` kept, as (2, E) int64 edges in row order.
    cKDTree ranks by f64 distance; the card ranks by the f32 distance^2
    dx*dx + dy*dy with ties to the lower index and cuts at the f32 radius^2,
    so the tree's ``cap + 1 + slack`` nearest (bound a little past the
    radius) are ranked and cut by that key. Also returns how many rows
    differ when the tree's own f64 order and cut are kept instead."""
    from scipy.spatial import cKDTree

    n = len(pts)
    d64, j = cKDTree(pts).query(pts, k=cap + 1 + slack,
                                distance_upper_bound=radius * (1 + 1e-5), workers=-1)
    jj = np.where(j < n, j, 0)
    notself = (j < n) & (jj != np.arange(n)[:, None])
    diff = pts[:, None, :] - pts[jj]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    valid = notself & (d2 <= np.float32(float(radius) ** 2))
    order = np.lexsort((jj, np.where(valid, d2, np.inf)), axis=-1)

    def capped(idx, ok):  # valid entries first, in their order, then the first ``cap``
        mat = np.where(ok, idx, -1)
        return np.take_along_axis(mat, np.argsort(mat < 0, axis=1, kind="stable"), axis=1)[:, :cap]

    ref = capped(np.take_along_axis(jj, order, 1), np.take_along_axis(valid, order, 1))
    raw = capped(jj, notself & (d64 <= radius))
    rr, cc = np.nonzero(ref >= 0)
    edges = np.stack([rr.astype(np.int64), ref[rr, cc].astype(np.int64)])
    return edges, int((ref != raw).any(axis=1).sum())


def _chain(slide, coords, nuclei, tmp: Path, wrappers, failures) -> dict:
    """The chain's embed and graph stages after the nuclei stage, on the
    same slide and tiles and on the nuclei table it wrote: CLIP ViT-B/16 at
    its published widths (seeded weights) through ``run_extract_features``
    at the default batch of 512, its bf16 features against the f32 forward
    on the card, that against the CPU's on 4 tiles, a mutant (the position
    embedding left out) that the cosine check must see, the forward timed
    at 512 tiles; ``build_cell_graph`` + ``analyze_graph`` over the nuclei
    table; ``radius_graph`` on GRAPH_POINTS seeded points, capped at
    GRAPH_CAP, which the module routes to the card (n * (cap + 1) is over
    ``HOST_TREE_CELL_BUDGET``), edge for edge against cKDTree. The port's
    kernel counts are set to 0 before the phase and read after: the chain
    launches none of them."""
    from importlib.util import find_spec

    import torch.nn.functional as F

    from path_gene_multimodal_tpu_torch.config import GraphConfig, default_config
    from path_gene_multimodal_tpu_torch.core.artifacts import read_features_h5
    from path_gene_multimodal_tpu_torch.models import clip
    from path_gene_multimodal_tpu_torch.ops import neighbors
    from path_gene_multimodal_tpu_torch.ops.cuda import exact_f32
    from path_gene_multimodal_tpu_torch.pipeline.embed import run_extract_features
    from path_gene_multimodal_tpu_torch.pipeline.graph import build_cell_graph
    from path_gene_multimodal_tpu_torch.pipeline.graph_stats import analyze_graph

    cfg = default_config()
    vcfg = clip.CLIP_VIT_B16
    res: dict = {"tiles": len(coords), "batch": cfg.embedding.batch_size}
    for w in wrappers.values():
        w.launches = 0

    # -- embed -------------------------------------------------------------
    t0 = time.perf_counter()
    enc = clip.ImageEncoder(vcfg, dtype=torch.bfloat16, device="cuda", seed=0)
    res["encoder_setup_s"] = time.perf_counter() - t0
    # whether the stage writes its artifacts (the features H5 needs h5py)
    # is decided here once, by whether h5py is installed
    write = find_spec("h5py") is not None
    res["artifacts_written"] = write
    out = tmp / "embed"
    run_extract_features(slide, coords, enc, out, "warm", cfg, write_artifacts=write)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = run_extract_features(slide, coords, enc, out, "smoke", cfg, write_artifacts=write)
    res["embed_s"] = time.perf_counter() - t0
    res["embed_tiles_per_s"] = len(coords) / res["embed_s"]
    if feats.shape != (len(coords), vcfg.out_dim) or feats.dtype != np.float32:
        failures.append(f"embed: features {feats.shape} {feats.dtype}")
    if not np.isfinite(feats).all():
        failures.append("embed: non-finite features")
    if write:
        back = read_features_h5(out / "smoke_features.h5")
        if not np.array_equal(back["features"], feats):
            failures.append("embed: the features H5 does not read back equal")

    tiles = torch.from_numpy(np.stack([slide.read_region((int(x), int(y)), 0, (224, 224))
                                       for x, y in coords]))
    sd = enc.model.state_dict()
    enc32 = clip.ImageEncoder(vcfg, state_dict=sd, dtype=torch.float32, device="cuda")
    with exact_f32():
        f32 = enc32(tiles)
    bf = torch.from_numpy(feats).to(f32.device)
    cos = F.cosine_similarity(bf.double(), f32.double(), dim=-1)
    res["min_cos_bf16_vs_f32"] = float(cos.min())
    res["mean_cos_bf16_vs_f32"] = float(cos.mean())
    if res["min_cos_bf16_vs_f32"] < EMBED_MIN_COS:
        failures.append(f"embed: bf16 vs f32 cosine {res['min_cos_bf16_vs_f32']:.6f} "
                        f"< {EMBED_MIN_COS}")
    cpu = clip.ImageEncoder(vcfg, state_dict={k: v.cpu() for k, v in sd.items()},
                            dtype=torch.float32, device="cpu")(tiles[:4])
    err = (f32[:4].cpu() - cpu).abs()
    res["f32_card_vs_cpu_max_abs"] = float(err.max())
    res["f32_card_vs_cpu_excess"] = float((err / (EMBED_ATOL + EMBED_RTOL * cpu.abs())).max())
    if res["f32_card_vs_cpu_excess"] > 1:
        failures.append(f"embed: f32 card vs CPU excess {res['f32_card_vs_cpu_excess']:.3f} > 1")
    pos = enc.model.visual.positional_embedding
    saved = pos.detach().clone()
    with torch.no_grad():
        pos.zero_()
        mutant = enc(tiles)
        pos.copy_(saved)
    res["mutant_no_pos_embed_min_cos"] = float(
        F.cosine_similarity(mutant.double(), f32.double(), dim=-1).min())
    if res["mutant_no_pos_embed_min_cos"] >= EMBED_MIN_COS:
        failures.append("embed: the check does not see the position embedding left out")
    del enc32, f32, bf, mutant, cpu

    batch = torch.cat([tiles, tiles]).cuda()  # 512 tiles on the card
    enc(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    enc(batch)
    ev[1].record()
    torch.cuda.synchronize()
    res["forward_512_ms"] = ev[0].elapsed_time(ev[1])
    res["forward_512_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["forward_512_ms_mean_of_3"] = _sync_time(lambda: enc(batch), reps=3, warm=0)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        enc(batch)
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    res["forward_512_device_ms_profiled"] = sum(e.self_device_time_total for e in ops) / 1e3
    res["forward_512_device_ms_by_op"] = {e.key: [e.self_device_time_total / 1e3, e.count]
                                          for e in ops[:12]}
    flops = _vit_flops(vcfg, len(batch))
    nbytes = batch.numel() + sum(t.numel() * 4 for t in sd.values()) + len(batch) * vcfg.out_dim * 4
    res["forward_512_bound_ms"], res["forward_512_bound_by"] = _bound_ms(nbytes, [(flops, PEAK_BF16)])
    res["forward_512_gflop"] = flops / 1e9
    res["forward_512_tflops"] = flops / res["forward_512_ms"] / 1e9
    del enc, batch, tiles
    torch.cuda.empty_cache()

    # -- graph -------------------------------------------------------------
    gcfg = GraphConfig()
    t0 = time.perf_counter()
    graph = build_cell_graph(nuclei, gcfg, tmp / "graph", "smoke", device="cuda")
    res["graph_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = analyze_graph(graph, tmp / "graph", "smoke")
    res["graph_stats_s"] = time.perf_counter() - t0
    n = len(graph.node_ids)
    res.update(graph_nodes=n, graph_knn_edges=int((graph.knn_index >= 0).sum()),
               graph_radius_edges=int(graph.edge_index.shape[1]),
               graph_mean_degree=stats["mean_degree"], graph_mean_clustering=stats["mean_clustering"])
    if n != len(nuclei) or not np.isfinite(graph.x).all() or not np.isfinite(graph.pos_um).all():
        failures.append("graph: node count or node features wrong")
    if graph.edge_index.size and not (0 <= graph.edge_index.min() <= graph.edge_index.max() < n):
        failures.append("graph: radius edges out of range")
    json.loads((tmp / "graph" / "smoke_graph_stats.json").read_text())  # strict JSON

    pts = _graph_points()
    radius = gcfg.radius_um
    routed = []
    scan = neighbors._neighbor_indices

    def spy(*a, **k):
        routed.append(1)
        return scan(*a, **k)

    neighbors._neighbor_indices = spy
    try:
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            ei, _ = neighbors.radius_graph(pts, radius, max_degree=GRAPH_CAP, device="cuda")
            times.append(time.perf_counter() - t0)
    finally:
        neighbors._neighbor_indices = scan
    t0 = time.perf_counter()
    ref, raw_rows = _ckdtree_radius_edges(pts, radius, GRAPH_CAP)
    deg = np.bincount(ei[0], minlength=len(pts))
    res.update(device_radius_points=len(pts), device_radius_um=radius,
               device_radius_cap=GRAPH_CAP, device_radius_routed_to_card=len(routed) == 2,
               device_radius_s=times, device_radius_edges=int(ei.shape[1]),
               device_radius_rows_at_cap=int((deg == GRAPH_CAP).sum()),
               device_radius_equal_ckdtree=bool(ei.shape == ref.shape and np.array_equal(ei, ref)),
               ckdtree_rows_differing_in_f64_order=raw_rows,
               ckdtree_s=time.perf_counter() - t0)
    if len(routed) != 2:
        failures.append("graph: radius_graph on the seeded points did not take the device route")
    if not res["device_radius_equal_ckdtree"]:
        failures.append(f"graph: device-route edges ({ei.shape[1]}) differ from cKDTree's "
                        f"({ref.shape[1]})")
    res["launches"] = {n: w.launches for n, w in wrappers.items()}
    failures += [f"the chain launched {n}" for n, k in res["launches"].items() if k]
    return res


def _split_tables(blob: bytes) -> tuple[bytes, bytes]:
    """(tables-only stream, abbreviated stream): the DQT/DHT segments of a
    JPEG moved into SOI ... EOI, as TIFF JPEGTables stores them."""
    sos = blob.find(b"\xff\xda")
    tables, rest, i = b"\xff\xd8", b"\xff\xd8", 2
    while i < sos:
        seg = blob[i: i + 2 + ((blob[i + 2] << 8) | blob[i + 3])]
        if seg[1] in (0xDB, 0xC4):
            tables += seg
        else:
            rest += seg
        i += len(seg)
    return tables + b"\xff\xd9", rest + blob[sos:]


def _pil_rgb(blob: bytes) -> np.ndarray:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(blob)) as img:
        return np.asarray(img.convert("RGB"))


def _rate(fn, n: int, reps: int = 3) -> float:
    """Items per second of ``fn`` over ``n`` items, best of ``reps`` runs."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return n / best


def _write_smoke_tiff(slide, path: Path) -> Path:
    """The smoke slide as a tiled JPEG TIFF in the Aperio SVS layout
    (256-px tiles, quality 90, 4:2:0; levels /1, /4, /16)."""
    from path_gene_multimodal_tpu_torch.io import tiff_write

    lv8 = slide._levels[3]
    h8, w8 = lv8.shape[0] // 2 * 2, lv8.shape[1] // 2 * 2
    lv16 = lv8[:h8, :w8].reshape(h8 // 2, 2, w8 // 2, 2, 3).mean(axis=(1, 3)).astype(np.uint8)
    return tiff_write.write_tiled_tiff(path, [slide._levels[0], slide._levels[2], lv16],
                                       tile_size=256, compression=7, jpeg_quality=90,
                                       description="Aperio smoke |MPP = 0.2500|")


def _feed(slide, roi, ann: Path, model, cfg, main_launches, tmp: Path, wrappers,
          failures) -> dict:
    """The slide feed from a real file: the smoke slide written as a tiled
    JPEG TIFF (256-px tiles, quality 90, 4:2:0, levels /1, /4, /16) by the
    port's writer; the port's decoder built by g++ (no libjpeg) and held on
    all 576 level-0 tiles to PIL (fancy RGB, bit for bit) and to itself
    (planar + ``ycbcr420_to_rgb`` on the card = its nearest RGB = the same
    on the CPU), on one tile split into tables + abbreviated stream, one
    with a restart interval, one 4:4:4, one progressive (refused, and
    counted by the reader, which decodes it through PIL), and a mutant
    with Cb and Cr swapped that the check must see; decode rates of the
    three forms at all cores and one thread beside PIL at one thread,
    bytes per tile and each batch's host-to-device copy, planar and RGB;
    the nuclei stage from the TIFF on the main run's ROI tiles with the
    planar feed (every chunk planar, no refusal, each batch's model input
    byte-equal to the host nearest decode padded by ``_pad_tile_to_input``,
    K1-K4 launched as often as in the main run), timed, and once with the
    planar feed off; the embed stage from the TIFF with the planar feed at
    batch 512, its features equal to the RGB feed of the host nearest
    decode."""
    from dataclasses import replace

    from path_gene_multimodal_tpu_torch.io import native
    from path_gene_multimodal_tpu_torch.io import tiff_write
    from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide
    from path_gene_multimodal_tpu_torch.models import clip
    from path_gene_multimodal_tpu_torch.ops.jpegcolor import ycbcr420_to_rgb
    from path_gene_multimodal_tpu_torch.pipeline import nuclei as nuc
    from path_gene_multimodal_tpu_torch.pipeline.embed import run_extract_features

    res: dict = {}
    dev = model.device
    # -- the decoder's build and the TIFF ------------------------------------
    t0 = time.perf_counter()
    native.build_native(force=True)
    res["decoder_build_s"] = time.perf_counter() - t0
    cmd = native.build_command(native.LIB_PATH)
    res["decoder_link_line"] = " ".join(cmd)
    if "-ljpeg" in cmd or b"libjpeg" in native.LIB_PATH.read_bytes():
        failures.append("feed: the decoder links libjpeg")
    lv0 = slide._levels[0]
    t0 = time.perf_counter()
    tif = _write_smoke_tiff(slide, tmp / "smoke.svs")
    res.update(tiff_write_s=time.perf_counter() - t0, tiff_bytes=tif.stat().st_size)
    reader = TiffTileSlide(tif)
    page = reader._pages[0]
    res["tiff_levels"] = reader.level_dimensions
    blobs = [reader._tile_bytes(page, i) for i in range(len(page.offsets))]
    n = len(blobs)
    res["level0_tiles"] = n

    # -- the decoder against PIL and itself ------------------------------------
    dec, dec1 = native.NativeTileDecoder(), native.NativeTileDecoder(num_threads=1)
    fancy = dec.decode_jpeg_batch(blobs, 256, 256)
    near = dec.decode_jpeg_batch_nearest(blobs, 256, 256)
    planes = dec.decode_jpeg_batch_planar(blobs, 256, 256)
    if fancy is None or near is None or planes is None:
        failures.append("feed: the decoder refused a tile of the smoke TIFF")
        return res
    pil = np.stack([_pil_rgb(b) for b in blobs])
    res["fancy_tiles_differing_from_pil"] = int((fancy != pil).reshape(n, -1).any(1).sum())
    y_d, c_d = torch.from_numpy(planes[0]).to(dev), torch.from_numpy(planes[1]).to(dev)
    card = ycbcr420_to_rgb(y_d, c_d).cpu().numpy()
    cpu = ycbcr420_to_rgb(torch.from_numpy(planes[0]), torch.from_numpy(planes[1])).numpy()
    mutant = ycbcr420_to_rgb(y_d, c_d.flip(-1)).cpu().numpy()
    res.update(planar_card_tiles_differing_from_nearest=int(
                   (card != near).reshape(n, -1).any(1).sum()),
               planar_card_equal_cpu=bool(np.array_equal(card, cpu)),
               mutant_cb_cr_swapped_tiles_differing=int(
                   (mutant != near).reshape(n, -1).any(1).sum()),
               fancy_vs_nearest_max=int(np.abs(fancy.astype(np.int16) - near).max()))
    if res["fancy_tiles_differing_from_pil"]:
        failures.append(f"feed: fancy RGB differs from PIL on "
                        f"{res['fancy_tiles_differing_from_pil']} tiles")
    if res["planar_card_tiles_differing_from_nearest"] or not res["planar_card_equal_cpu"]:
        failures.append("feed: planar + ycbcr420_to_rgb on the card differs from the nearest "
                        "decode or from the CPU")
    if res["mutant_cb_cr_swapped_tiles_differing"] == 0:
        failures.append("feed: the check does not see Cb and Cr swapped")

    import io

    from PIL import Image

    tile = lv0[roi[0][1]: roi[0][1] + 256, roi[0][0]: roi[0][0] + 256]

    def encode(**kw) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(tile)).save(buf, "JPEG", quality=90, **kw)
        return buf.getvalue()

    cases = {}
    full = encode(subsampling=2)
    tables, abbrev = _split_tables(full)
    ref_forms = [dec.decode_jpeg_batch([full], 256, 256), dec.decode_jpeg_batch_nearest(
        [full], 256, 256), dec.decode_jpeg_batch_planar([full], 256, 256)]
    got_forms = [dec.decode_jpeg_batch([abbrev], 256, 256, tables),
                 dec.decode_jpeg_batch_nearest([abbrev], 256, 256, tables),
                 dec.decode_jpeg_batch_planar([abbrev], 256, 256, tables)]
    cases["tables_abbreviated"] = all(
        g is not None and all(np.array_equal(a, b) for a, b in zip(
            g if isinstance(g, tuple) else (g,), r if isinstance(r, tuple) else (r,)))
        for g, r in zip(got_forms, ref_forms)) and b"\xff\xdb" not in abbrev
    rst = encode(subsampling=2, restart_marker_blocks=3)
    got = dec.decode_jpeg_batch([rst], 256, 256)
    cases["restart_interval"] = (b"\xff\xdd" in rst and got is not None
                                 and np.array_equal(got[0], _pil_rgb(rst)))
    s444 = encode(subsampling=0)
    got = dec.decode_jpeg_batch([s444], 256, 256)
    _, st = dec.decode_jpeg_status([s444], 256, 256, form="planar")
    cases["sampling_444"] = (got is not None and np.array_equal(got[0], _pil_rgb(s444))
                             and native.REFUSALS.get(int(st[0])) == "not_planar")
    # a progressive tile: refused by the decoder, read through PIL and counted
    prog = encode(subsampling=2, progressive=True)
    _, st = dec.decode_jpeg_status([prog], 256, 256)
    real = tiff_write.encode_jpeg
    tiff_write.encode_jpeg = lambda rgb, quality=90: prog
    try:
        ptif = tiff_write.write_tiled_tiff(tmp / "prog.svs", [tile], tile_size=256,
                                           compression=7)
    finally:
        tiff_write.encode_jpeg = real
    pslide = TiffTileSlide(ptif)
    pread = pslide.read_region((0, 0), 0, (256, 256))
    cases["progressive_refused"] = native.REFUSALS.get(int(st[0])) == "progressive"
    cases["progressive_counted"] = (pslide.decoder_refusals == 1 and dict(
        pslide.decoder_refusal_reasons) == {"progressive": 1})
    cases["progressive_pixels_equal_pil"] = bool(np.array_equal(pread, _pil_rgb(prog)))
    res["cases"] = cases
    failures += [f"feed: decoder case {k} failed" for k, ok in cases.items() if not ok]

    # -- rates, bytes, copies ----------------------------------------------------
    rates = {}
    for name, d in (("all_cores", dec), ("one_thread", dec1)):
        rates[f"fancy_{name}"] = _rate(lambda: d.decode_jpeg_batch(blobs, 256, 256), n)
        rates[f"nearest_{name}"] = _rate(lambda: d.decode_jpeg_batch_nearest(blobs, 256, 256), n)
        rates[f"planar_{name}"] = _rate(lambda: d.decode_jpeg_batch_planar(blobs, 256, 256), n)
    rates["pil_one_thread"] = _rate(lambda: [_pil_rgb(b) for b in blobs], n, reps=1)
    res["decode_tiles_per_s"] = rates
    t = cfg.patch_size
    res["bytes_per_tile"] = {"planar": t * t + (t // 2) * (t // 2) * 2, "rgb": t * t * 3,
                             "rgb_padded_nuclei_input": 256 * 256 * 3}
    b = cfg.hovernext.batch_size
    host = {"planar": (torch.zeros((b, t, t), dtype=torch.uint8).pin_memory(),
                       torch.zeros((b, t // 2, t // 2, 2), dtype=torch.uint8).pin_memory()),
            "rgb": (torch.zeros((b, t, t, 3), dtype=torch.uint8).pin_memory(),),
            "rgb_padded_nuclei_input": (torch.zeros((b, 256, 256, 3), dtype=torch.uint8)
                                        .pin_memory(),)}
    res["h2d_ms_per_batch"] = {
        k: _sync_time(lambda v=v: [x.to(dev, non_blocking=True) for x in v], reps=10)
        for k, v in host.items()}
    res["h2d_batch_tiles"] = b

    # -- the nuclei stage from the TIFF ----------------------------------------
    canvas = np.full((page.tiles_down * 256, page.tiles_across * 256, 3), 255, np.uint8)
    for i in range(n):
        ty, tx = divmod(i, page.tiles_across)
        canvas[ty * 256:(ty + 1) * 256, tx * 256:(tx + 1) * 256] = near[i]
    inputs = []
    seg = model.segment_async

    def spy(tiles_u8):
        inputs.append(tiles_u8.cpu())
        return seg(tiles_u8)

    model.segment_async = spy
    try:
        nuc.run_hovernet_pipeline_on_wsi_tiles(TiffTileSlide(tif), ann, tmp, "feed_check",
                                               model, cfg)
    finally:
        del model.segment_async
    expect = np.stack([nuc._pad_tile_to_input(canvas[y: y + t, x: x + t],
                                              model.cfg.input_size)[0] for x, y in roi])
    got_inputs = torch.cat(inputs).numpy()
    res["nuclei_input_batches"] = len(inputs)
    res["nuclei_inputs_equal_host_nearest"] = bool(
        len(inputs) == -(-len(roi) // b) and np.array_equal(got_inputs[: len(roi)], expect)
        and not got_inputs[len(roi):].any())
    if not res["nuclei_inputs_equal_host_nearest"]:
        failures.append("feed: the nuclei stage's model inputs differ from the host nearest "
                        "decode padded by _pad_tile_to_input")
    for w in wrappers.values():
        w.launches = 0
    tslide = TiffTileSlide(tif)
    t0 = time.perf_counter()
    table = nuc.run_hovernet_pipeline_on_wsi_tiles(tslide, ann, tmp, "feed", model, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    routes = table.attrs["feed_routes"]
    res.update(nuclei_tiles=len(roi), nuclei_s=dt, nuclei_tiles_per_s=len(roi) / dt,
               nuclei=len(table), nuclei_routes=routes, nuclei_launches=launches,
               nuclei_decoder_refusals=tslide.decoder_refusals)
    if routes["rgb"] or routes["planar"] != -(-len(roi) // b):
        failures.append(f"feed: not every nuclei chunk took the planar route: {routes}")
    if tslide.decoder_refusals:
        failures.append(f"feed: {tslide.decoder_refusals} decoder refusals on the smoke TIFF")
    for k in ("convnext_block", "cc_sizes", "flood", "instance_stats"):
        if launches[k] != main_launches[k]:
            failures.append(f"feed: {k} launched {launches[k]} times, the main run "
                            f"{main_launches[k]}")
    failures += [f"feed: {k} launched on the nuclei path" for k, v in launches.items()
                 if k not in ("convnext_block", "cc_sizes", "flood", "instance_stats") and v]
    failures += _table_failures(table, t, "feed nuclei")
    rgb_cfg = replace(cfg, hovernext=replace(cfg.hovernext, planar_feed=False))
    tslide = TiffTileSlide(tif)
    t0 = time.perf_counter()
    table_rgb = nuc.run_hovernet_pipeline_on_wsi_tiles(tslide, ann, tmp, "feed_rgb", model,
                                                       rgb_cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res.update(nuclei_rgb_feed_s=dt, nuclei_rgb_feed_tiles_per_s=len(roi) / dt,
               nuclei_rgb_feed=len(table_rgb), nuclei_rgb_feed_routes=table_rgb.attrs["feed_routes"])
    if table_rgb.attrs["feed_routes"]["planar"]:
        failures.append("feed: the RGB-feed run took the planar route")

    # -- the embed stage from the TIFF -------------------------------------------
    enc = clip.ImageEncoder(clip.CLIP_VIT_B16, dtype=torch.bfloat16, device=dev, seed=0)
    eb = cfg.embedding.batch_size
    run_extract_features(TiffTileSlide(tif), roi, enc, tmp, "feed_warm", cfg,
                         write_artifacts=False)
    torch.cuda.synchronize()
    eslide = TiffTileSlide(tif)
    t0 = time.perf_counter()
    feats = run_extract_features(eslide, roi, enc, tmp, "feed", cfg, write_artifacts=False)
    dt = time.perf_counter() - t0
    tiles = np.zeros((-(-len(roi) // eb) * eb, t, t, 3), np.uint8)
    tiles[: len(roi)] = [canvas[y: y + t, x: x + t] for x, y in roi]
    ref = torch.cat([enc(torch.from_numpy(tiles[i: i + eb])) for i in range(0, len(tiles), eb)])
    ref = ref.cpu().numpy()[: len(roi)]
    res.update(embed_tiles=len(roi), embed_batch=eb, embed_s=dt,
               embed_tiles_per_s=len(roi) / dt,
               embed_features_equal_rgb_nearest=bool(np.array_equal(feats, ref)),
               embed_max_abs_diff=float(np.abs(feats - ref).max()),
               embed_decoder_refusals=eslide.decoder_refusals)
    if not res["embed_features_equal_rgb_nearest"]:
        failures.append(f"feed: planar embed features differ from the RGB feed of the host "
                        f"nearest decode (max {res['embed_max_abs_diff']:.3g})")
    del enc
    torch.cuda.empty_cache()
    return res


def _d2h_ms(tensors: list[torch.Tensor], reps: int = 10) -> float:
    """Device-to-host copy of ``tensors`` into pinned buffers, ms per copy."""
    bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    return _sync_time(lambda: [b.copy_(t, non_blocking=True) for b, t in zip(bufs, tensors)],
                      reps=reps)


def _groups_equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        np.array_equal(a[k][0], b[k][0]) and np.array_equal(a[k][1], b[k][1]) for k in a)


def _prefix_equal(count: int, pidx, pvals, flat_dense, budget: int, mask) -> bool:
    """A pack's truncation contract against the dense arrays: ``count`` is
    the true count, and its first ``min(count, budget)`` entries are the
    first set positions of ``mask`` with the dense values there."""
    true = np.flatnonzero(mask)
    m = min(count, budget)
    return (count == len(true) and np.array_equal(pidx[:m].numpy(), true[:m])
            and all(np.array_equal(v[:m].numpy(), fd[true[:m]])
                    for v, fd in zip(pvals, flat_dense)))


def _sparse_batches(caught: dict, slots: int, nw, inst) -> tuple[list[dict], list[str]]:
    """Each caught batch of the second WSI run, its packs against the dense
    device tensors copied whole. At the budget the run packed with: the
    count is the true count, and the entries are the first ``min(count,
    budget)`` nonzero pixels (live slots) with their values, in order; a
    mutant pack that drops its last entry within the budget must differ.
    At that budget, or where the batch overflowed it at the smallest rung
    that holds it (packed again), the unpacked labels and live slots equal
    the dense ones exactly, and ``groups_from_sparse`` equals
    ``_group_instance_pixels`` (host ms of both). Also the bytes and copy
    ms of the run's sparse and dense routes."""
    rows, bad = [], []
    for k, ((lbl, lb, lpack), (feats, fb, fpack)) in enumerate(
            zip(caught["labels"], caught["features"])):
        b, h, w = lbl.shape
        lbl_ladder, feat_ladder = nw.budget_ladders(b * h * w, b * slots)
        cnt, idx, ids = (t.cpu() for t in lpack)
        fcnt, fidx = fpack[0].cpu(), fpack[1].cpu()
        fpacked = {kk: v.cpu() for kk, v in fpack[2].items()}
        dense = lbl.cpu().numpy()
        dfeats = {kk: v.cpu().numpy() for kk, v in feats.items()}
        n, fn = int(cnt), int(fcnt)
        row = {"batch": k, "label_rung": lbl_ladder.index(lb), "label_budget": lb,
               "nonzero_px": n, "feature_rung": feat_ladder.index(fb), "feature_budget": fb,
               "live_slots": fn, "labels_overflow": n > lb, "features_overflow": fn > fb}
        flat = dense.reshape(-1)
        live = dfeats["area"] > 0
        keys = list(dfeats)
        row["labels_prefix_equal_dense"] = _prefix_equal(n, idx, [ids], [flat], lb, flat != 0)
        row["live_slots_prefix_equal_dense"] = _prefix_equal(
            fn, fidx, [fpacked[kk] for kk in keys], [dfeats[kk].reshape(-1) for kk in keys], fb,
            live.reshape(-1))
        if n:
            mutant = ids.clone()
            mutant[min(n, lb) - 1] = 0
            row["mutant_drop_last_differs"] = not _prefix_equal(n, idx, [mutant], [flat], lb,
                                                                 flat != 0)
        if n > lb:
            lb = next(r for r in lbl_ladder + [b * h * w] if r >= n)
            cnt, idx, ids = (t.cpu() for t in inst.pack_labels_sparse(lbl, lb))
            row["label_budget_repacked"] = lb
        if fn > fb:
            fb = next(r for r in feat_ladder + [b * slots] if r >= fn)
            fcnt, fidx, fp = inst.pack_features_sparse(feats, fb)
            fcnt, fidx, fpacked = fcnt.cpu(), fidx.cpu(), {kk: v.cpu() for kk, v in fp.items()}
            row["feature_budget_repacked"] = fb
        row["labels_equal_dense"] = bool(np.array_equal(
            inst.unpack_labels_sparse(cnt, idx, ids, dense.shape), dense))
        got = inst.unpack_features_sparse(fcnt, fidx, fpacked, b, slots)
        row["live_slots_equal_dense"] = all(
            np.array_equal(got[kk][live], v[live]) and not got[kk][~live].any()
            for kk, v in dfeats.items())
        t0 = time.perf_counter()
        sparse_groups = inst.groups_from_sparse(cnt, idx, ids, b, h, w)
        row["groups_from_sparse_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        dense_groups = [nw._group_instance_pixels(dense[i]) for i in range(b)]
        row["group_instance_pixels_ms"] = (time.perf_counter() - t0) * 1e3
        row["groups_equal"] = all(_groups_equal(x, y) for x, y in zip(sparse_groups, dense_groups))
        if not all(row[c] for c in ("labels_prefix_equal_dense", "live_slots_prefix_equal_dense",
                                    "labels_equal_dense", "live_slots_equal_dense",
                                    "groups_equal")):
            bad.append(f"wsi: batch {k}'s packs differ from its dense tensors ({row})")
        if row.get("mutant_drop_last_differs") is False:
            bad.append(f"wsi: batch {k}: the check does not see a pack that drops its last "
                       "entry")
        sparse_t = [*lpack, fpack[0], fpack[1], *fpack[2].values()]
        dense_t = [lbl, *feats.values()]
        row["bytes"] = {"sparse": sum(t.numel() * t.element_size() for t in sparse_t),
                        "dense": sum(t.numel() * t.element_size() for t in dense_t)}
        row["copy_ms"] = {"sparse": _d2h_ms(sparse_t), "dense": _d2h_ms(dense_t)}
        rows.append(row)
    return rows, bad


def _hidden_rows(rows: list, clipped: list, pixels: list, hidden, w0: int, h0: int,
                 last: tuple[int, int]) -> dict:
    """Where the rows sat that the stitcher left with no map pixel: each one
    beside the kept row that covers most of its pixels (the windows, bboxes,
    areas and views of both, that row's share of the hidden row's pixels,
    the pair's pixel IoU and centroid distance); and how many kept rows own
    at most half of their pixels (partly covered by later rows). ``rows``,
    ``clipped`` and ``pixels`` are the stitcher's rows before painting, in
    paint order; ``last`` the clamped last window's x and y."""
    owner = np.zeros(h0 * w0, np.int32)  # the row index + 1, painted in row order
    lin = [ys * w0 + xs for ys, xs in pixels]
    for i, li in enumerate(lin):
        owner[li] = i + 1
    owned = np.bincount(owner, minlength=len(lin) + 1)[1:]
    size = np.array([len(li) for li in lin])

    def view(i: int) -> dict:
        r = rows[i]
        return {"row": i, "window": [int(r["tile_x"]), int(r["tile_y"])],
                "bbox": [float(r[f"wsi_bbox_{k}"]) for k in ("xmin", "ymin", "xmax", "ymax")],
                "area": float(r["area"]), "clipped": bool(clipped[i])}

    out = []
    for i in np.flatnonzero(hidden):
        ids, cnt = np.unique(owner[lin[i]], return_counts=True)
        j = int(ids[np.argmax(cnt)]) - 1
        inter = np.intersect1d(lin[i], lin[j]).size
        dist = float(np.hypot(rows[i]["wsi_centroid_x"] - rows[j]["wsi_centroid_x"],
                              rows[i]["wsi_centroid_y"] - rows[j]["wsi_centroid_y"]))
        out.append({"hidden": view(int(i)), "cover": view(j), "coverers": len(ids),
                    "share": float(cnt.max() / size[i]),
                    "iou": float(inter / (size[i] + size[j] - inter)), "centroid_dist": dist})
    kept = ~np.asarray(hidden, bool)
    edge = [any(e["hidden"]["window"][a] == last[a] or e["cover"]["window"][a] == last[a]
                for a in (0, 1)) for e in out]
    return {
        "n": len(out), "rows": out,
        "single_coverer": sum(e["coverers"] == 1 for e in out),
        "both_clean": sum(not (e["hidden"]["clipped"] or e["cover"]["clipped"]) for e in out),
        "in_clamped_edge_windows": int(sum(edge)),
        "min_share": min((e["share"] for e in out), default=None),
        "iou_min_median_max": ([float(q) for q in np.quantile([e["iou"] for e in out],
                                                             [0, 0.5, 1])] if out else None),
        "max_centroid_dist": max((e["centroid_dist"] for e in out), default=None),
        "max_area_ratio": max((e["cover"]["area"] / e["hidden"]["area"] for e in out),
                              default=None),
        "kept_rows": int(kept.sum()),
        "kept_owning_at_most_half": int((kept & (owned * 2 <= size)).sum()),
        "kept_owning_less_than_all": int((kept & (owned < size)).sum()),
    }


def _wsi(slide, tif: Path, sd, model, cfg, main, tmp: Path, wrappers, failures) -> dict:
    """The sliding-window WSI mode on the smoke TIFF, timed with the
    kernels' counts, its map against its table; a second run on its first
    two chunks with the packs caught (sparse = dense on every batch, the
    transport's bytes and copy ms per route, the grouping's host ms) and K4
    at 256^2 bit-equal to its plain version; the CLI on an odd-sided crop
    in both modes."""
    import pandas as pd

    from path_gene_multimodal_tpu_torch.cli import hovernext_infer
    from path_gene_multimodal_tpu_torch.io import tiff_write
    from path_gene_multimodal_tpu_torch.io.slide import ArraySlide
    from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide
    from path_gene_multimodal_tpu_torch.ops import cuda
    from path_gene_multimodal_tpu_torch.ops import instance_stats as k4
    from path_gene_multimodal_tpu_torch.ops import instances as inst
    from path_gene_multimodal_tpu_torch.pipeline import nuclei as nuc
    from path_gene_multimodal_tpu_torch.pipeline import nuclei_wsi as nw

    res: dict = {}
    if not tif.exists():
        _write_smoke_tiff(slide, tif)
        res["tiff_written_again"] = True
    batch, window = cfg.hovernext.batch_size, model.cfg.input_size
    stride = int(round(window * cfg.hovernext.overlap))
    tslide = TiffTileSlide(tif)
    w0, h0 = tslide.level_dimensions[0]
    windows = nw.iter_windows(w0, h0, window, stride)
    n_b = -(-len(windows) // batch)
    res.update(slide=[w0, h0], window=window, stride=stride, windows=len(windows), batches=n_b,
               batch=batch)
    main_kernels = ("convnext_block", "cc_sizes", "flood", "instance_stats")

    # -- 1. the timed run, its launches ------------------------------------------
    out = tmp / "wsi"
    for w in wrappers.values():
        w.launches = 0
    # the stitcher's rows before painting and the paint's hidden rows,
    # caught by reference (their evidence is taken after the timed run)
    stitched: dict = {}
    real_dedup, real_paint = nw._dedup_seam_duplicates, nw._paint

    def dedup(rows, *a, **k):
        kept = real_dedup(rows, *a, **k)
        stitched.update(rows=kept, clipped=[bool(r.get("_clipped")) for r in kept])
        return kept

    def paint(pixels, *a):
        o = real_paint(pixels, *a)
        stitched.update(pixels=pixels, hidden=o[2])
        return o

    nw._dedup_seam_duplicates, nw._paint = dedup, paint
    try:
        t0 = time.perf_counter()
        map_path, table = nw.run_hovernext_wsi(tslide, out, "smoke", model, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        nw._dedup_seam_duplicates, nw._paint = real_dedup, real_paint
    launches = {k: w.launches for k, w in wrappers.items()}
    timing = table.attrs["timing"]
    dev_ms = timing["device_ms"]
    res.update(
        s=dt, windows_per_s=len(windows) / dt, per_tile_tiles_per_s=main["tiles_per_s"],
        nuclei=len(table), launches=launches,
        cc_sizes_adaptive_reruns=launches["cc_sizes"] - 4 * n_b,
        routes=table.attrs["feed_routes"], decoder_refusals=tslide.decoder_refusals,
        cc_slot_overflow_tiles=table.attrs["cc_slot_overflow_tiles"],
        budget_levels=table.attrs["sparse_budget_levels"], transport=table.attrs["transport"],
        hidden_rows_dropped=table.attrs["hidden_rows_dropped"],
        split_s={"decode_wait": timing["decode_wait_s"], "device": sum(dev_ms) / 1e3,
                 "host_rows": timing["host_rows_s"], "unpack_and_group": timing["unpack_groups_s"],
                 "stitcher": timing["stitch_s"], "finalize_npz_zip": timing["finalize_s"]},
        device_ms_per_batch=dev_ms)
    want = {"convnext_block": 15 * n_b, "flood": n_b, "instance_stats": n_b}
    failures += [f"wsi: {k} launched {launches[k]} times, expected {v}"
                 for k, v in want.items() if launches[k] != v]
    if res["cc_sizes_adaptive_reruns"] < 0:
        failures.append(f"wsi: cc_sizes launched {launches['cc_sizes']} times, under 4 a batch")
    failures += [f"wsi: {k} launched on the WSI path" for k, v in launches.items()
                 if k not in main_kernels and v]
    if res["routes"] != {"planar": n_b, "rgb": 0} or tslide.decoder_refusals:
        failures.append(f"wsi: not every chunk took the planar route: {res['routes']}, "
                        f"{tslide.decoder_refusals} refusals")

    # -- 2. the map against the table ----------------------------------------------
    m = nw.load_instance_map(map_path)
    counts = np.bincount(m.ravel(), minlength=len(table) + 1)
    owned = counts[table["inst_id"].to_numpy()]
    mz = nw.load_instance_map(out / "smoke_pinst_pp.zip")
    res.update(
        map_shape=list(m.shape), map_ids_are_1_to_rows=bool(
            len(counts) == len(table) + 1 and table["inst_id"].tolist()
            == list(range(1, len(table) + 1)) and (counts[1:] > 0).all()),
        rows_owning_no_pixel=int((owned == 0).sum()),
        rows_owning_more_than_area=int((owned > table["area"].to_numpy()).sum()),
        npz_equal_zip=bool(np.array_equal(m, mz)))
    del m, mz
    res["hidden_rows"] = _hidden_rows(stitched["rows"], stitched["clipped"], stitched["pixels"],
                                      stitched["hidden"], w0, h0, (windows[-1][0], windows[-1][1]))
    del stitched
    if not res["map_ids_are_1_to_rows"]:
        failures.append("wsi: the map's ids are not exactly 1..rows")
    if res["rows_owning_no_pixel"] or res["rows_owning_more_than_area"]:
        failures.append(f"wsi: {res['rows_owning_no_pixel']} rows own no map pixel, "
                        f"{res['rows_owning_more_than_area']} more than their area")
    if not res["npz_equal_zip"]:
        failures.append("wsi: the npz map differs from the zip map")
    failures += _table_failures(table, window, "wsi")

    # -- 3. the first two chunks again, the packs caught -------------------------------
    caught: dict = {"labels": [], "features": [], "stats": []}
    real = {n: getattr(nw, n) for n in ("pack_labels_sparse", "pack_features_sparse",
                                         "instance_features_batch", "iter_windows")}

    def pack_labels(lbl, budget):
        o = real["pack_labels_sparse"](lbl, budget)
        caught["labels"].append((lbl, budget, o))
        return o

    def pack_features(feats, budget):
        o = real["pack_features_sparse"](feats, budget)
        caught["features"].append((feats, budget, o))
        return o

    def features(li, ti, max_instances):
        caught["stats"].append((li, ti))
        return real["instance_features_batch"](li, ti, max_instances=max_instances)

    nw.pack_labels_sparse, nw.pack_features_sparse = pack_labels, pack_features
    nw.instance_features_batch = features
    nw.iter_windows = lambda *a: real["iter_windows"](*a)[: 2 * batch]
    try:
        nw.run_hovernext_wsi(TiffTileSlide(tif), tmp / "wsi_spy", "spy", model, cfg)
    finally:
        for n, f in real.items():
            setattr(nw, n, f)
    torch.cuda.synchronize()
    res["sparse_batches"], bad = _sparse_batches(caught, model.max_instances, nw, inst)
    failures += bad
    if len(res["sparse_batches"]) != 2:
        failures.append(f"wsi: {len(res['sparse_batches'])} packed batches caught, expected 2")

    # -- 4. K4 on the first batch's 256^2 windows ----------------------------------------
    li, ti = caught["stats"][0]
    del caught
    slots, nt = model.max_instances, 6
    geo = k4.tiling(*li.shape, slots, nt, cuda.sm_count(li.device))
    with torch.inference_mode():
        got = k4.instance_stats(li, ti, slots, nt)
        want_stats = k4.instance_stats_plain(li, ti, slots, nt)
        res["k4_256"] = {
            "shape": list(li.shape), "cluster": geo.cluster, "narrow_32bit_sums": geo.narrow,
            "vector_rows": geo.vector_rows, "bit_equal": _bit_equal(got, want_stats),
            "live_slots": int((got[0][..., 0] > 0).sum()),
            "ms": _sync_time(lambda: k4.instance_stats(li, ti, slots, nt), reps=50),
            "device_ms": _queued_ms(lambda: k4.instance_stats(li, ti, slots, nt), reps=50)}
    nbytes = li.numel() * 8 + got[0].numel() * 4 + got[1].numel() * 4
    res["k4_256"]["bound_ms"], res["k4_256"]["bound_by"] = _bound_ms(
        nbytes, [(li.numel() * 12, PEAK_F32)])
    if not res["k4_256"]["bit_equal"]:
        failures.append("wsi: K4 on the 256^2 windows differs from its plain version")
    del li, ti, got, want_stats

    # -- 5. the CLI on an odd-sided crop, both modes --------------------------------------
    ck = tmp / "sd.pt"
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, ck)
    # the 2047 x 2049 region with the most tissue, on a 256-px grid (the
    # top-left one is background)
    lv0 = slide._levels[0]
    tissue = (lv0[::16, ::16] != 243).any(-1)
    cy, cx = max(((y, x) for y in range(0, lv0.shape[0] - 2049 + 1, 256)
                  for x in range(0, lv0.shape[1] - 2047 + 1, 256)),
                 key=lambda p: tissue[p[0] // 16: (p[0] + 2049) // 16,
                                      p[1] // 16: (p[1] + 2047) // 16].mean())
    crop = np.ascontiguousarray(lv0[cy: cy + 2049, cx: cx + 2047])
    tif2 = tiff_write.write_tiled_tiff(tmp / "crop.svs", [crop], tile_size=256, compression=7,
                                       jpeg_quality=90, description="Aperio crop |MPP = 0.2500|")
    ann2 = _annotations(ArraySlide(crop), cfg.patch_size, None, tmp / "crop_annotations.csv")
    cli: dict = {"crop": [2047, 2049], "crop_at": [cx, cy],
                 "windows": len(nw.iter_windows(2047, 2049, window, stride))}
    _, direct = nw.run_hovernext_wsi(TiffTileSlide(tif2), tmp / "direct", "crop", model, cfg)
    cli["direct_wsi_rows"] = len(direct)
    cli["direct_wsi_routes"] = direct.attrs["feed_routes"]
    direct_tiles = nuc.run_hovernet_pipeline_on_wsi_tiles(TiffTileSlide(tif2), ann2,
                                                          tmp / "direct", "crop", model, cfg)
    cli["direct_tiles_rows"] = len(direct_tiles)
    cli["roi_tiles"] = int(pd.read_csv(ann2)["in_tme_roi"].sum())
    for mode, extra in (("wsi", []), ("tiles", ["--annotations-csv", str(ann2)])):
        dest = tmp / f"cli_{mode}"
        t0 = time.perf_counter()
        rc = hovernext_infer.main(["--input", str(tif2), "--output", str(dest), "--mode", mode,
                                   "--batch-size", str(batch), "--checkpoint", str(ck), *extra])
        cli[f"{mode}_s"] = time.perf_counter() - t0
        cli[f"{mode}_rc"] = rc
        files = ["crop_hovernet_nuclei_wsi.csv", "crop_hovernet_nuclei_wsi.parquet"]
        if mode == "wsi":
            files += ["crop_pinst_pp.npz", "crop_pinst_pp.zip"]
        cli[f"{mode}_files"] = {f: (dest / f).exists() for f in files}
        cli[f"{mode}_rows"] = (len(pd.read_csv(dest / files[0])) if (dest / files[0]).exists()
                               else None)
        if rc != 0 or not all(cli[f"{mode}_files"].values()) or not cli[f"{mode}_rows"]:
            failures.append(f"wsi: the CLI in --mode {mode} returned {rc}, files "
                            f"{cli[f'{mode}_files']}, rows {cli[f'{mode}_rows']}")
    # every row of windows ends at x = 1791, so every chunk takes the RGB route
    want_routes = {"planar": 0, "rgb": -(-cli["windows"] // batch)}
    if cli["direct_wsi_routes"] != want_routes or cli["windows"] != 81:
        failures.append(f"wsi: the odd-sided crop's {cli['windows']} windows took "
                        f"{cli['direct_wsi_routes']}, expected {want_routes} of 81")
    res["cli"] = cli
    torch.cuda.empty_cache()
    return res

def _wsi_line(res: dict) -> dict:
    """The ``wsi`` JSON line: rates, the split, launches, checks, and each
    caught batch's transport."""
    keys = ("windows", "batches", "s", "windows_per_s", "per_tile_tiles_per_s", "nuclei",
            "split_s", "device_ms_per_batch", "launches", "cc_sizes_adaptive_reruns", "routes",
            "budget_levels", "transport", "hidden_rows_dropped", "hidden_rows",
            "map_ids_are_1_to_rows",
            "rows_owning_no_pixel",
            "rows_owning_more_than_area", "npz_equal_zip", "k4_256", "cli")
    line = {k: res.get(k) for k in keys}
    if line["hidden_rows"]:  # each row's evidence is in chip_smoke.json
        line["hidden_rows"] = {k: v for k, v in line["hidden_rows"].items() if k != "rows"}
    line["sparse_batches"] = [
        {k: b.get(k) for k in ("label_rung", "nonzero_px", "feature_rung", "live_slots",
                               "label_budget_repacked", "feature_budget_repacked",
                               "labels_prefix_equal_dense", "live_slots_prefix_equal_dense",
                               "labels_equal_dense", "live_slots_equal_dense",
                               "mutant_drop_last_differs", "groups_equal", "bytes", "copy_ms",
                               "groups_from_sparse_ms", "group_instance_pixels_ms")}
        for b in res.get("sparse_batches", [])]
    return line


def _forward_parts(model, stacked: torch.Tensor):
    """One forward of the TTA-folded batch, timed by part with CUDA events:
    (outputs, last decoder map, {part: ms})."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        ev[0].record()
        feats = model.encoder(stacked.to(torch.bfloat16))
        ev[1].record()
        x = model.decode(feats)
        ev[2].record()
        out = model.final_stage(x)
        ev[3].record()
    torch.cuda.synchronize()
    parts = ("encoder", "decoder", "final_stage_and_heads")
    return out, x, {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(parts)}


def _rel_span(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / (max ref - min ref)."""
    span = float(ref.max() - ref.min()) or 1.0
    return float((a - ref).abs().max()) / span


def _subset(n: int) -> torch.Tensor:
    """The images a plain version is held to when it cannot take the whole
    TTA batch: 16 of each rotation's 128 views, the batch's last 16 among
    them (their offsets pass 2^31 elements in K8)."""
    return torch.cat([torch.arange(k * CHUNK, k * CHUNK + 16) for k in range(3)]
                     + [torch.arange(n - 16, n)])


def _decoder_configs(slide, cfg, sd, tmp, pixels, model, wrappers, report, failures):
    """Section 5: each decoder configuration through the nuclei stage over
    one batch, its forward against the default's, and its forward by part.
    Returns the configurations' NucleiModels (the default's first) and the
    launch counts of each configuration's run."""
    from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY
    from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt
    from path_gene_multimodal_tpu_torch.pipeline.nuclei import (
        NucleiModel, run_hovernet_pipeline_on_wsi_tiles,
    )

    dev = pixels.device
    bsz = cfg.hovernext.batch_size
    ann1 = _annotations(slide, cfg.patch_size, bsz, tmp / "batch_annotations_with_coords.csv")

    def build(opt):
        m = HoverNeXt(HOVERNEXT_TINY, **opt, run_on=dev)
        m.load_state_dict(sd)
        m = m.to(device=dev, dtype=torch.bfloat16).eval()
        m.fuse()
        return m

    models = {"default": model}
    for name, (opt, _) in CONFIGS.items():
        models[name] = NucleiModel(cfg=HOVERNEXT_TINY, model=build(opt), device=dev,
                                   tta=cfg.hovernext.tta,
                                   max_instances=cfg.hovernext.max_instances_per_tile)
    timed_only = [("resize", build({"fused_final": False})),  # the plain resize path
                  ("lowres_decoder", build({"lowres_decoder": True}))]

    stacked = torch.cat([torch.rot90(pixels, k, dims=(1, 2)) for k in range(4)], dim=0)
    breakdown, vs_default, ref = {}, {}, None
    for name, m in [(n, nm.model) for n, nm in models.items()] + timed_only:
        _forward_parts(m, stacked)  # warm-up: cuDNN plans, allocator
        out, _, parts = _forward_parts(m, stacked)
        breakdown[name] = {**parts, "total": sum(parts.values())}
        if ref is None:
            ref = out
            continue
        vs_default[name] = {k: _rel_span(out[k], ref[k]) for k in ref}
        for k, v in vs_default[name].items():
            if not v < 2e-2:
                failures.append(f"{name}: forward differs from the default's in {k} by "
                                f"{v:.3g} of its span (bar 2e-2)")
        del out
    del ref, stacked, timed_only

    runs, counts = {}, {}
    for name, nm in models.items():
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        nuclei = run_hovernet_pipeline_on_wsi_tiles(slide, ann1, tmp, f"cfg_{name}", nm, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[name] = {n: w.launches for n, w in wrappers.items()}
        runs[name] = {"tiles": bsz, "s": dt, "tiles_per_s": bsz / dt, "nuclei": len(nuclei),
                      "launches": counts[name]}
        failures.extend(_table_failures(nuclei, cfg.patch_size, name))
        expect = CONFIGS[name][1] if name in CONFIGS else {}
        for n, k in expect.items():
            if counts[name][n] != k:
                failures.append(f"{name}: {n} launched {counts[name][n]} times over one batch, "
                                f"expected {k}")
        print(f"config {name}: {bsz} tiles in {dt:.3f} s, {len(nuclei)} nuclei", flush=True)
    report["configs"] = {"runs": runs, "forward_ms": breakdown, "vs_default": vs_default}
    print(json.dumps({"configs": {n: {"tiles_per_s": r["tiles_per_s"], "nuclei": r["nuclei"]}
                                  for n, r in runs.items()},
                      "forward_ms": {n: b["total"] for n, b in breakdown.items()}}), flush=True)
    return models, counts


def _conv_edge(x, w, b, exact_gelu=False):
    """GELU(conv3x3(x) + b) in f32 with x padded by edge replication instead
    of the conv's zeros: the edge mutant of the final-stage kernels' plain
    versions (x, w, b bf16)."""
    import torch.nn.functional as F

    from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu_kernel

    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    y = F.conv2d(xp, w.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + b.float()
    return gelu_kernel(y, exact_gelu)


def _k7_mutant(x, skip, w, b, ln_scale, ln_bias, exact_gelu=False, edge=False, ln_half=False):
    """A mutant of K7's plain version: the input padded by edge replication
    instead of zeros (``edge``), or the LayerNorm statistics taken over the
    first half of cout only (``ln_half``)."""
    import torch.nn.functional as F

    from path_gene_multimodal_tpu_torch.ops.convnext_block import gelu_kernel

    f = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    xin = f(x) if skip is None else torch.cat([f(x), f(skip)], dim=-1)
    xin = xin.permute(0, 3, 1, 2)
    wk = f(w).permute(3, 2, 0, 1)
    if edge:
        acc = F.conv2d(F.pad(xin, (1, 1, 1, 1), mode="replicate"), wk)
    else:
        acc = F.conv2d(xin, wk, padding=1)
    del xin
    acc = acc.permute(0, 2, 3, 1) + f(b)
    stats = acc[..., : acc.shape[-1] // 2] if ln_half else acc
    mu = stats.mean(-1, keepdim=True)
    var = (stats - mu).square().mean(-1, keepdim=True)
    acc = (acc - mu) * torch.rsqrt(var + 1e-6) * f(ln_scale) + f(ln_bias)
    return gelu_kernel(acc, exact_gelu).to(torch.bfloat16)


def _k7_mutants(x, skip, w, vb, vg, vl) -> dict:
    """The mutants K7's check must catch: a dropped bias, LayerNorm scale 1,
    the input edge-replicated, the LayerNorm statistics over half of cout,
    and with a skip, its half of the weight zeroed or read at offset 0
    (x's rows) instead of cx."""
    from path_gene_multimodal_tpu_torch.ops import decoder as dec

    mut = {"no_bias": lambda: dec.decoder_conv_plain(x, skip, w, 0 * vb, vg, vl),
           "ln_scale=1": lambda: dec.decoder_conv_plain(x, skip, w, vb, 1 + 0 * vg, vl),
           "edge_replicated": lambda: _k7_mutant(x, skip, w, vb, vg, vl, edge=True),
           "ln_stats_half_cout": lambda: _k7_mutant(x, skip, w, vb, vg, vl, ln_half=True)}
    if skip is not None:
        cx, cs = x.shape[-1], skip.shape[-1]

        def skip_rows(fill):
            bad = w.clone()
            bad[:, :, cx:] = fill
            return dec.decoder_conv_plain(x, skip, bad, vb, vg, vl)

        mut["skip_half_zeroed"] = lambda: skip_rows(0)
        mut["skip_weights_at_offset_0"] = lambda: skip_rows(w[:, :, :cs])
    return mut


def _edge_padded(x, w, b, exact_gelu=False):
    """A mutant of K9's plain version: the upsampled map padded by edge
    replication instead of the conv's zeros."""
    from path_gene_multimodal_tpu_torch.ops import decoder as dec

    up = dec.upsample2x_bilinear(x.to(torch.bfloat16))
    return _conv_edge(up, w, b, exact_gelu).to(torch.bfloat16)


def _heads_edge(x, w, b, wh, bh):
    """The edge mutant of a conv + GELU + head plain version (K11 at low
    resolution): the GELU output rounded to bf16 through the head."""
    y = _conv_edge(x, w, b).to(torch.bfloat16).float()
    return (y @ wh.float() + bh.float()).to(torch.bfloat16)


def _k11_head(whb: torch.Tensor, seed: int) -> torch.Tensor:
    """A block-diagonal head of whb's shape with a different block per
    phase, drawn from ``seed`` at the scale of whb's nonzero entries: the
    model repeats one block, under which a phase mix-up would not show."""
    c4, n4 = whb.shape
    gen = torch.Generator().manual_seed(seed)
    std = float(whb.float()[whb != 0].std())
    blocks = [std * torch.randn((c4 // 4, n4 // 4), generator=gen) for _ in range(4)]
    return torch.block_diag(*blocks).to(whb.device, whb.dtype).contiguous()


def _conv64_ptxas(cuda) -> dict[str, dict]:
    """ptxas registers, stack and spills of ``csrc/conv64.cu``'s kernels."""
    return _ptxas_entries(cuda.build_log("conv64"))


def _check_decoder_kernels(models, pixels, counts, failures) -> list[dict]:
    """Section 6: K7, K8, K9, K10, K11 against their plain versions on this
    batch's activations at full shape, both GELU modes, with mutants; K9
    and K10 also at ragged shapes; timings. Returns the kernels' entries of
    the JSON line."""
    import torch.nn.functional as F

    from path_gene_multimodal_tpu_torch.ops import decoder as dec

    bf = torch.bfloat16
    stacked = torch.cat([torch.rot90(pixels, k, dims=(1, 2)) for k in range(4)], dim=0)
    n = stacked.shape[0]
    idx = _subset(n).to(pixels.device)
    src = "path_gene_multimodal_tpu_torch/csrc/decoder_conv.cu"
    src_up = "path_gene_multimodal_tpu_torch/csrc/upsample_conv.cu"
    src_64 = "path_gene_multimodal_tpu_torch/csrc/conv64.cu"
    ptxas_64 = _conv64_ptxas(dec.cuda)
    ptxas_7 = _ptxas_entries(dec.cuda.build_log("decoder_conv"))
    # K7's and K8/K11's kernels (every instantiation) must not spill
    for lib, kern, info_of in (("decoder_conv", "decoder_conv_kernel", ptxas_7),
                               ("conv64", "conv64_kernel", ptxas_64)):
        for kname, info in info_of.items():
            if kern in kname and (info.get("spill_stores", 0) or info.get("spill_loads", 0)):
                failures.append(f"{lib} kernel {kname} spills: {info}")
        if not any(kern in k for k in info_of):
            failures.append(f"{lib}: no ptxas lines for {kern} in its build log")
    pallas = "path_gene_multimodal_tpu/ops/pallas/decoder.py"
    entries = []

    def conv_lib(x_nhwc, w_hwio):
        """cuDNN's conv at the same shape: bf16, channels-last, no epilogue."""
        w = w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(x_nhwc.permute(0, 3, 1, 2), w, padding=1)

    def modes(name, kernel, plain, atol_of, mutants, rec):
        """Both GELU modes (tanh last: its plain output is the mutants'
        reference); each mutant must fail the same tolerance."""
        for exact in (True, False):
            got, ref = kernel(exact), plain(exact)
            mode = "erf" if exact else "tanh"
            atol = atol_of(exact)
            rec[f"max_abs_err_{mode}"] = float((got.float() - ref.float()).abs().max())
            rec[f"excess_{mode}"] = _excess(got, ref, atol)
            rec[f"max_atol_{mode}"] = float(torch.as_tensor(atol).max())
            if rec[f"excess_{mode}"] > 1.0:
                failures.append(f"{name} ({mode} GELU): |kernel - plain| exceeds 2 ulp + atol "
                                f"(<= {rec[f'max_atol_{mode}']:.3g}) by "
                                f"x{rec[f'excess_{mode}']:.3g}")
            del got
        for what, bad in mutants.items():
            rec[f"excess_if_{what}"] = _excess(bad(), ref, atol)
            if rec[f"excess_if_{what}"] <= 1.0:
                failures.append(f"{name}: the check does not see {what}")
        return max(rec["max_abs_err_erf"], rec["max_abs_err_tanh"])

    def entry(name, replaces, err, ms, pms, bnd, by, lms, note, source=src, **extra):
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bnd, "bound_by": by, "library_ms": lms, "note": note,
                        **extra})

    # K7: the 8 decoder conv steps of the fused_decoder configuration
    m = models["fused_decoder"].model
    calls = []
    with torch.inference_mode():
        feats = m.encoder(stacked.to(bf))
        x = feats[-1]
        for i, (blk, skip, (w0, w1)) in enumerate(
                zip(m.decoder, [feats[2], feats[1], feats[0], None], m.fused_weights["k7"])):
            xu = dec.upsample2x_nearest(x)
            x = dec.decoder_conv(xu, skip, *w0)
            calls.append((f"dec{i}.conv0", xu, skip, w0[0]))
            calls.append((f"dec{i}.conv1", x, None, w1[0]))
            x = dec.decoder_conv(x, None, *w1)
        x_dec = x
        del feats
    k7 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "err": 0.0, "calls": []}
    by_t = {"bytes": 0.0, "operations": 0.0}
    for j, (cname, xin, skip, w) in enumerate(calls):
        b, h, wd, cx = xin.shape
        cs = 0 if skip is None else skip.shape[-1]
        cout = w.shape[-1]
        vb, vg, vl = (_seeded(w[0, 0, 0], 200 + 3 * j), _seeded(w[0, 0, 0], 201 + 3 * j, 1.0),
                      _seeded(w[0, 0, 0], 202 + 3 * j))
        rec = {"call": cname, "shape": [b, h, wd, cx, cs, cout]}
        with torch.inference_mode():
            err = modes(
                f"decoder_conv {cname}",
                lambda e: dec.decoder_conv(xin, skip, w, vb, vg, vl, exact_gelu=e),
                lambda e: dec.decoder_conv_plain(xin, skip, w, vb, vg, vl, exact_gelu=e),
                lambda e: DEC_ATOL, _k7_mutants(xin, skip, w, vb, vg, vl), rec)
            ms = _sync_time(lambda: dec.decoder_conv(xin, skip, w, vb, vg, vl), reps=3)
            pms = _sync_time(lambda: dec.decoder_conv_plain(xin, skip, w, vb, vg, vl), reps=1)
            xcat = xin if skip is None else torch.cat([xin, skip], dim=-1)
            lms = _sync_time(conv_lib(xcat, w), reps=3)
            del xcat
        px = b * h * wd
        cin = cx + cs
        nbytes = 2 * px * (cin + cout) + 2 * w.numel()
        bnd, by = _bound_ms(nbytes, [(2 * px * 9 * cin * cout, PEAK_BF16),
                                     (20 * px * cout, PEAK_F32)])
        geo = dec.DecoderConvTiling(b, h, wd, cx, cs, cout,
                                    slots=dec._k7_slots(cout, xin.device))
        rec.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bnd, bound_by=by,
                   l2_bytes_estimate=geo.l2_bytes(), hbm_bytes=nbytes,
                   geometry=dict(zip(("tile_h", "tile_w", "taps", "ring_w", "ring_h", "cluster",
                                      "grid", "smem_bytes"), geo.launch_args())))
        k7["calls"].append(rec)
        for key, v in (("ms", ms), ("plain_ms", pms), ("bound_ms", bnd), ("library_ms", lms)):
            k7[key] += v
        k7["err"] = max(k7["err"], err)
        by_t[by] += bnd
    del calls
    # K7 where H or W is no multiple of its tile: halo, edge and store faults
    # show at the ragged last tiles
    k7["ragged"] = []
    for j, (rb, rh, rw, cx, cs, cout) in enumerate(K7_RAGGED):
        gen = torch.Generator().manual_seed(800 + j)
        xr = torch.randn((rb, rh, rw, cx), generator=gen).to(pixels.device, bf)
        sr = torch.randn((rb, rh, rw, cs), generator=gen).to(pixels.device, bf) if cs else None
        wr = (torch.randn((3, 3, cx + cs, cout), generator=gen) * (9 * (cx + cs)) ** -0.5).to(
            pixels.device, bf)
        vb, vg, vl = (_seeded(wr[0, 0, 0], 810 + 3 * j), _seeded(wr[0, 0, 0], 811 + 3 * j, 1.0),
                      _seeded(wr[0, 0, 0], 812 + 3 * j))
        r7 = {"shape": [rb, rh, rw, cx, cs, cout]}
        with torch.inference_mode():
            modes(f"decoder_conv {rb}x{rh}x{rw}x{cx}+{cs}->{cout}",
                  lambda e: dec.decoder_conv(xr, sr, wr, vb, vg, vl, exact_gelu=e),
                  lambda e: dec.decoder_conv_plain(xr, sr, wr, vb, vg, vl, exact_gelu=e),
                  lambda e: DEC_ATOL, _k7_mutants(xr, sr, wr, vb, vg, vl), r7)
        k7["ragged"].append(r7)
    print(json.dumps({"k7_calls": [{k: c[k] for k in ("call", "ms", "library_ms", "bound_ms",
                                                      "l2_bytes_estimate")}
                                   for c in k7["calls"]]}), flush=True)
    entry("decoder_conv", f"{pallas}:168", k7["err"], k7["ms"], k7["plain_ms"], k7["bound_ms"],
          max(by_t, key=by_t.get), k7["library_ms"],
          "per batch: the 8 calls of one forward (512 images); library_ms: cuDNN conv2d alone "
          "at each call's shape on the concatenated input (conv only, no bias/LN/GELU); "
          "vectors drawn from a seed; both GELU modes: |kernel - plain| <= 2 bf16 ulp + "
          f"{DEC_ATOL}, elementwise, all 512 images, and at the ragged shapes (see ragged); "
          "calls[].l2_bytes_estimate: weights and halos the kernel reads through L2 "
          "(DecoderConvTiling.l2_bytes)", calls=k7["calls"], ragged=k7["ragged"], ptxas=ptxas_7)

    # K8: once over the whole 512-image batch (2^31 elements in and out)
    w8, b8 = m.fused_weights["k8"]
    with torch.inference_mode():
        xf = torch.cat([dec.upsample2x_bilinear(c) for c in x_dec.split(CHUNK)])
        vb = _seeded(b8, 300)
        rec = {"shape": list(xf.shape), "numel": xf.numel(), "subset": idx.tolist()}
        xs = xf[idx]
        err = modes("final_conv_gelu",
                    lambda e: dec.final_conv_gelu(xf, w8, vb, exact_gelu=e)[idx],
                    lambda e: dec.final_conv_gelu_plain(xs, w8, vb, exact_gelu=e),
                    lambda e: DEC_ATOL,
                    {"no_bias": lambda: dec.final_conv_gelu_plain(xs, w8, 0 * vb),
                     "edge_replicated": lambda: _conv_edge(xs, w8, vb).to(bf)}, rec)
        del xs
        rec["upsample_ms_per_batch"] = _sync_time(
            lambda: [dec.upsample2x_bilinear(c) for c in x_dec.split(CHUNK)], reps=2)
        rec["ms_per_call"] = _sync_time(lambda: dec.final_conv_gelu(xf[:CHUNK], w8, vb), reps=3)
        rec["ms_whole_batch_one_call"] = _sync_time(lambda: dec.final_conv_gelu(xf, w8, vb), reps=2)
        ms = _sync_time(lambda: [dec.final_conv_gelu(c, w8, vb) for c in xf.split(CHUNK)], reps=2)
        pms = _sync_time(lambda: [dec.final_conv_gelu_plain(c, w8, vb) for c in xf.split(CHUNK)],
                         reps=1)
        lms = _sync_time(lambda: [conv_lib(c, w8)() for c in xf.split(CHUNK)], reps=2)
    px = xf.shape[0] * xf.shape[1] * xf.shape[2]
    cin, cout = w8.shape[2:]
    bnd, by = _bound_ms(2 * px * (cin + cout) + 2 * w8.numel(),
                        [(2 * px * 9 * cin * cout, PEAK_BF16), (10 * px * cout, PEAK_F32)])
    rec["geometry"] = dict(zip(("strip_h", "strip_w", "step_rows", "ring", "grid", "smem_bytes"),
                               dec.StripTiling(CHUNK, *xf.shape[1:3],
                                               n_sm=dec.cuda.sm_count(xf.device)).launch_args()))
    del xf
    # K8 where W is no multiple of its 64-column strip (H must stay a
    # multiple of 32): strip, ring and edge faults show at the last strip
    rec["ragged"] = []
    for j, (rb, rh, rw) in enumerate(K8_RAGGED):
        xr = torch.randn((rb, rh, rw, cin), generator=torch.Generator().manual_seed(740 + j))
        xr = xr.to(x_dec.device, bf)
        r8 = {"shape": [rb, rh, rw]}
        with torch.inference_mode():
            vr = _seeded(b8, 750 + j)
            modes(f"final_conv_gelu {rb}x{rh}x{rw}",
                  lambda e: dec.final_conv_gelu(xr, w8, vr, exact_gelu=e),
                  lambda e: dec.final_conv_gelu_plain(xr, w8, vr, exact_gelu=e),
                  lambda e: DEC_ATOL,
                  {"no_bias": lambda: dec.final_conv_gelu_plain(xr, w8, 0 * vr),
                   "edge_replicated": lambda: _conv_edge(xr, w8, vr).to(bf)}, r8)
        rec["ragged"].append(r8)
    entry("final_conv_gelu", f"{pallas}:591", err, ms, pms, bnd, by, lms,
          "per batch: 4 calls of 128 images as the forward makes them; the check runs one call "
          "over all 512 images (2^31 elements) and compares the subset, and ragged shapes (see "
          "ragged); library_ms: cuDNN conv2d alone (conv only); tolerance 2 bf16 ulp + "
          f"{DEC_ATOL}", source=src_64, ptxas=ptxas_64, **rec)

    # K10 and K11 on the plain decoder's output (the heads and pallas configurations)
    with torch.inference_mode():
        mh = models["heads"].model
        x_pl = mh.decode(mh.encoder(stacked.to(bf)))
        xs = x_pl[idx]
    del stacked

    def head_atol(y, wh):
        """Per logit (pixel, n): DEC_ATOL + two flipped bf16 roundings of the
        pixel's largest GELU output, each through column n's largest head
        weight."""
        return (DEC_ATOL + 2 * _bf16_ulp(y.float().abs().amax(-1, keepdim=True))
                * wh.float().abs().amax(0))

    w10, b10, wh, bh = mh.fused_weights["k10"]
    with torch.inference_mode():
        vb, vbh = _seeded(b10, 400), _seeded(bh, 401)
        rec = {"subset": "as final_conv_gelu"}
        err = modes(
            "final_heads",
            lambda e: dec.final_heads(x_pl, w10, vb, wh, vbh, exact_gelu=e)[idx],
            lambda e: dec.final_heads_plain(xs, w10, vb, wh, vbh, exact_gelu=e),
            lambda e: head_atol(dec.final_conv_gelu_plain(dec.upsample2x_bilinear(xs), w10, vb,
                                                          exact_gelu=e), wh),
            {"no_bias": lambda: dec.final_heads_plain(xs, w10, 0 * vb, wh, vbh),
             "no_head_bias": lambda: dec.final_heads_plain(xs, w10, vb, wh, 0 * vbh),
             "edge_replicated": lambda: (_edge_padded(xs, w10, vb).float() @ wh.float()
                                         + vbh.float()).to(bf)}, rec)
        rec["ms_per_call"] = _sync_time(lambda: dec.final_heads(x_pl[:CHUNK], w10, vb, wh, vbh),
                                        reps=3)
        ms = _sync_time(lambda: [dec.final_heads(c, w10, vb, wh, vbh) for c in x_pl.split(CHUNK)],
                        reps=2)
        pms = _sync_time(lambda: [dec.final_heads_plain(c, w10, vb, wh, vbh)
                                  for c in x_pl.split(CHUNK)], reps=1)
        up = dec.upsample2x_bilinear(x_pl[:CHUNK])
        lib = conv_lib(up, w10)
        lms = _sync_time(lambda: [lib() for _ in range(n // CHUNK)], reps=2)
        del up, lib
    px = n * 4 * x_pl.shape[1] * x_pl.shape[2]
    cin, cout, n_out = w10.shape[2], w10.shape[3], wh.shape[-1]
    # scalar work: each upsampled element once (6 ops), bias + GELU (10)
    bnd, by = _bound_ms(2 * (x_pl.numel() + px * n_out) + 2 * (w10.numel() + wh.numel()),
                        [(2 * px * (9 * cin * cout + cout * n_out), PEAK_BF16),
                         (6 * px * cin + 10 * px * cout, PEAK_F32)])
    rec["geometry"] = dict(zip(("tile_h", "tile_w", "grid", "smem_bytes"),
                               dec.UpsampleTiling(CHUNK, *x_pl.shape[1:3], head=True,
                                                  n_sm=dec.cuda.sm_count(x_pl.device)
                                                  ).launch_args()))
    entry("final_heads", f"{pallas}:392", err, ms, pms, bnd, by, lms,
          "per batch: 4 calls of 128 images; the check runs one call over all 512 and compares "
          "the subset, and ragged shapes (see ragged); library_ms: cuDNN conv2d alone on the "
          "upsampled map (conv only, no upsample/GELU/heads); tolerance per logit: 2 bf16 ulp + "
          "DEC_ATOL + two flipped roundings of the pixel's largest GELU output through the "
          "column's largest head weight", source=src_up, **rec)

    # K11 with a different head block per phase, so that the check sees
    # which phase's block each phase takes
    wc, b4, whb, bh4 = models["pallas"].model.fused_weights["k11"][:4]
    whs = _k11_head(whb, 502)
    with torch.inference_mode():
        vb, vbh = _seeded(b4, 500), _seeded(bh4, 501)
        rec = {"subset": "as final_conv_gelu"}
        err = modes(
            "composite_final_heads",
            lambda e: dec.composite_final_heads(x_pl, wc, vb, whs, vbh, exact_gelu=e)[idx],
            lambda e: dec.composite_final_heads_plain(xs, wc, vb, whs, vbh, exact_gelu=e),
            lambda e: head_atol(dec.final_conv_gelu_plain(xs, wc, vb, exact_gelu=e), whs),
            {"no_bias": lambda: dec.composite_final_heads_plain(xs, wc, 0 * vb, whs, vbh),
             "no_head_bias": lambda: dec.composite_final_heads_plain(xs, wc, vb, whs, 0 * vbh),
             "edge_replicated": lambda: _heads_edge(xs, wc, vb, whs, vbh),
             "phase_permuted": lambda: dec.composite_final_heads_by_phase(
                 xs, wc, vb, whs, vbh, head_of=(1, 2, 3, 0))},
            rec)
        rec["ms_per_call"] = _sync_time(lambda: dec.composite_final_heads(
            x_pl[:CHUNK], wc, vb, whb, vbh, block_diagonal=True), reps=3)
        # the model's head, as the path passes it (block-diagonal as built)
        ms = _sync_time(lambda: [dec.composite_final_heads(c, wc, vb, whb, vbh,
                                                           block_diagonal=True)
                                 for c in x_pl.split(CHUNK)], reps=2)
        pms = _sync_time(lambda: [dec.composite_final_heads_plain(c, wc, vb, whb, vbh)
                                  for c in x_pl.split(CHUNK)], reps=1)
        lms = _sync_time(lambda: [conv_lib(c, wc)() for c in x_pl.split(CHUNK)], reps=2)
    px = n * x_pl.shape[1] * x_pl.shape[2]
    c4, n4 = whb.shape
    # the block-diagonal head counts its four nonzero (c4/4, n4/4) blocks only
    bnd, by = _bound_ms(2 * (x_pl.numel() + px * n4) + 2 * (wc.numel() + whb.numel()),
                        [(2 * px * (9 * wc.shape[2] * c4 + c4 * n4 // 4), PEAK_BF16),
                         (10 * px * c4, PEAK_F32)])
    rec["geometry"] = dict(zip(("strip_h", "strip_w", "step_rows", "ring", "grid", "smem_bytes"),
                               dec.StripTiling(CHUNK, *x_pl.shape[1:3], phases=4,
                                               n_sm=dec.cuda.sm_count(x_pl.device)
                                               ).launch_args()))
    # K11 at odd half-resolution shapes: ragged strips and rows
    rec["ragged"] = []
    for j, (rb, rh, rw) in enumerate(HALF_RAGGED):
        xr = torch.randn((rb, rh, rw, wc.shape[2]),
                         generator=torch.Generator().manual_seed(760 + j)).to(x_pl.device, bf)
        r11 = {"shape": [rb, rh, rw]}
        wr = _k11_head(whb, 770 + j)
        with torch.inference_mode():
            vr, vrh = _seeded(b4, 780 + j), _seeded(bh4, 790 + j)
            modes(f"composite_final_heads {rb}x{rh}x{rw}",
                  lambda e: dec.composite_final_heads(xr, wc, vr, wr, vrh, exact_gelu=e),
                  lambda e: dec.composite_final_heads_plain(xr, wc, vr, wr, vrh, exact_gelu=e),
                  lambda e: head_atol(dec.final_conv_gelu_plain(xr, wc, vr, exact_gelu=e), wr),
                  {"no_bias": lambda: dec.composite_final_heads_plain(xr, wc, 0 * vr, wr, vrh),
                   "no_head_bias": lambda: dec.composite_final_heads_plain(xr, wc, vr, wr,
                                                                           0 * vrh),
                   "edge_replicated": lambda: _heads_edge(xr, wc, vr, wr, vrh),
                   "phase_permuted": lambda: dec.composite_final_heads_by_phase(
                       xr, wc, vr, wr, vrh, head_of=(1, 2, 3, 0))}, r11)
        rec["ragged"].append(r11)
    # the kernel reads only the diagonal head blocks: a head with a nonzero
    # block off the diagonal must be refused, not answered
    dense = whs.clone()
    dense[0, -1] = 0.5
    try:
        dec.composite_final_heads(xr, wc, vr, dense, vrh)
        failures.append("K11 answered a head with a nonzero off-diagonal block")
        rec["off_diagonal_head_refused"] = False
    except ValueError:
        rec["off_diagonal_head_refused"] = True
    entry("composite_final_heads", f"{pallas}:462", err, ms, pms, bnd, by, lms,
          "per batch: 4 calls of 128 images with the model's head; the check runs one call over "
          "all 512 and compares the subset, and ragged shapes (see ragged), with a seeded head "
          "block per phase; bound counts the head's nonzero blocks only (the kernel reads only "
          "those); library_ms: cuDNN conv2d alone (conv only); tolerance as final_heads",
          source=src_64, ptxas=ptxas_64, **rec)

    # K9 on the plain decoder's output (the fused_final=True configuration)
    w9, b9 = models["k9"].model.fused_weights["k9"]
    with torch.inference_mode():
        vb = _seeded(b9, 600, mean=-1.0, std=1.0)
        rec = {"subset": "as final_conv_gelu"}
        err = modes(
            "upsample_final",
            lambda e: dec.upsample_final(x_pl, w9, vb, exact_gelu=e)[idx],
            lambda e: dec.upsample_final_plain(xs, w9, vb, exact_gelu=e),
            lambda e: K9_ATOL,
            {"no_bias": lambda: dec.upsample_final_plain(xs, w9, 0 * vb),
             "other_gelu_mode": lambda: dec.upsample_final_plain(xs, w9, vb, exact_gelu=True),
             "edge_replicated": lambda: _edge_padded(xs, w9, vb)},
            rec)
        rec["ms_per_call"] = _sync_time(lambda: dec.upsample_final(x_pl[:CHUNK], w9, vb), reps=3)
        ms = _sync_time(lambda: [dec.upsample_final(c, w9, vb) for c in x_pl.split(CHUNK)], reps=2)
        pms = _sync_time(lambda: [dec.upsample_final_plain(c, w9, vb) for c in x_pl.split(CHUNK)],
                         reps=1)
        up = dec.upsample2x_bilinear(x_pl[:CHUNK])
        lib = conv_lib(up, w9)
        lms = _sync_time(lambda: [lib() for _ in range(n // CHUNK)], reps=2)
        del up, lib
    px = n * 4 * x_pl.shape[1] * x_pl.shape[2]
    cin, cout = w9.shape[2], w9.shape[3]
    bnd, by = _bound_ms(2 * (x_pl.numel() + px * cout) + 2 * w9.numel(),
                        [(2 * px * 9 * cin * cout, PEAK_BF16),
                         (6 * px * cin + 10 * px * cout, PEAK_F32)])
    rec["geometry"] = dict(zip(("tile_h", "tile_w", "grid", "smem_bytes"),
                               dec.UpsampleTiling(CHUNK, *x_pl.shape[1:3],
                                                  n_sm=dec.cuda.sm_count(x_pl.device)
                                                  ).launch_args()))

    # K9 and K10 where the output is no multiple of their tile: halo, window
    # and edge faults show at the ragged last tiles
    ragged = []
    for j, (rb, rh, rw) in enumerate(HALF_RAGGED):
        gen = torch.Generator().manual_seed(700 + j)
        xr = torch.randn((rb, rh, rw, w9.shape[2]), generator=gen).to(x_pl.device, bf)
        with torch.inference_mode():
            vb, vb10, vbh = (_seeded(b9, 710 + j, mean=-1.0, std=1.0), _seeded(b10, 720 + j),
                             _seeded(bh, 730 + j))
            r9 = {"kernel": "upsample_final", "shape": [rb, rh, rw]}
            r10 = {"kernel": "final_heads", "shape": [rb, rh, rw]}
            modes(f"upsample_final {rb}x{rh}x{rw}",
                  lambda e: dec.upsample_final(xr, w9, vb, exact_gelu=e),
                  lambda e: dec.upsample_final_plain(xr, w9, vb, exact_gelu=e),
                  lambda e: K9_ATOL, {"edge_replicated": lambda: _edge_padded(xr, w9, vb)}, r9)
            modes(f"final_heads {rb}x{rh}x{rw}",
                  lambda e: dec.final_heads(xr, w10, vb10, wh, vbh, exact_gelu=e),
                  lambda e: dec.final_heads_plain(xr, w10, vb10, wh, vbh, exact_gelu=e),
                  lambda e: head_atol(dec.upsample_final_plain(xr, w10, vb10, exact_gelu=e), wh),
                  {"edge_replicated": lambda: (_edge_padded(xr, w10, vb10).float() @ wh.float()
                                               + vbh.float()).to(bf)}, r10)
        ragged += [r9, r10]
    k10 = next(e for e in entries if e["name"] == "final_heads")
    k10["ragged"] = [r for r in ragged if r["kernel"] == "final_heads"]
    entry("upsample_final", f"{pallas}:307", err, ms, pms, bnd, by, lms,
          "per batch: 4 calls of 128 images; the check runs one call over all 512 and compares "
          f"the subset, and ragged shapes (see ragged); bias drawn around -1; tolerance 2 bf16 "
          f"ulp + {K9_ATOL}; library_ms: cuDNN conv2d alone on the upsampled map (conv only, no "
          "upsample/GELU)", source=src_up,
          ragged=[r for r in ragged if r["kernel"] == "upsample_final"], **rec)
    return entries


def _flood_mutant(dist, markers, mask, kind: str, levels: int = 64):
    """A mutant of K3's plain version that the label-and-count check must
    catch: ``"gauss_seidel"`` updates labels in place (even rows, then the
    odd rows reading the even rows' new labels, so a label can cross two
    rows in one step), ``"no_fresh"`` lets phase 0 grow from markers whose
    own q is the level, ``"cap64"`` stops a phase after 64 steps (the XLA
    flood's cap). Returns (labels, counts as the kernel's)."""
    from path_gene_multimodal_tpu_torch.ops.components import INF
    from path_gene_multimodal_tpu_torch.ops.flood import _neighbor_min, quantize

    q = quantize(dist, levels)
    lbl = torch.where(markers >= INF, INF, markers).to(torch.int32)
    is_marker = lbl < INF
    mask = mask.bool()
    steps = torch.zeros(lbl.shape[0], dtype=torch.int64, device=lbl.device)
    max_rounds = 63 if kind == "cap64" else 64
    even = (torch.arange(lbl.shape[1], device=lbl.device) % 2 == 0)[None, :, None]
    for level in range(levels - 1, -1, -1):
        eligible = mask & (q >= level)
        fresh = is_marker & (q == level)
        for allow_fresh in (False, True):
            base = q >= level
            if not (allow_fresh or kind == "no_fresh"):
                base = base & ~fresh

            def grow(l, rows):
                nb = _neighbor_min(torch.where((l < INF) & base, l, INF))
                return torch.where(eligible & (l == INF) & (nb < INF) & rows, nb, l)

            def step(l):
                return grow(grow(l, even), ~even) if kind == "gauss_seidel" else grow(l, True)

            new = step(lbl)
            ch = (new != lbl).flatten(1).any(1)
            steps += 1
            lbl, it = new, 0
            while bool(ch.any()) and it < max_rounds:
                new = step(lbl)
                steps += ch
                ch = (new != lbl).flatten(1).any(1)
                lbl, it = new, it + 1
    counts = torch.stack([steps.sum(), steps.max(), (lbl < INF).sum() - is_marker.sum()])
    return lbl, counts


def _cc_late_mutant(mask, seg_len: int, max_iters: int = 256):
    """A mutant of K2's relaxation that the label-and-count check must
    catch: column runs cut every ``seg_len`` rows, each segment taking the
    other segments' minima one pass late (the full column runs' minima of
    the pass before). Returns (labels, counts as the kernel's)."""
    import torch.nn.functional as F

    from path_gene_multimodal_tpu_torch.ops.components import INF, _run_min_lastdim, index_seeds

    mask = mask.bool()
    b, h, w = mask.shape
    mt = mask.transpose(-1, -2).contiguous()
    pad = -h % seg_len
    mseg = F.pad(mt, (0, pad)).reshape(b, -1, seg_len)

    def relax(lbl, late):
        lbl = _run_min_lastdim(lbl, mask).transpose(-1, -2).contiguous()
        full = _run_min_lastdim(lbl, mt)
        seg = _run_min_lastdim(F.pad(lbl, (0, pad), value=INF).reshape(b, -1, seg_len), mseg)
        seg = seg.reshape(b, w, h + pad)[..., :h]
        new = torch.where(mt, torch.minimum(seg, late), INF)
        return new.transpose(-1, -2).contiguous(), full.transpose(-1, -2).contiguous()

    seeds = index_seeds(mask)
    lbl, late = relax(seeds, torch.full_like(seeds.transpose(-1, -2), INF))
    ch = (lbl != seeds).flatten(1).any(1)
    passes = torch.ones(b, dtype=torch.int64, device=mask.device)
    it = 0
    while bool(ch.any()) and it < max_iters:
        new, late = relax(lbl, late.transpose(-1, -2))
        passes += ch
        ch = (new != lbl).flatten(1).any(1)
        lbl, it = new, it + 1
    return lbl, torch.stack([passes.sum(), passes.max()])


def _smooth(gen: torch.Generator, b: int, h: int, w: int) -> torch.Tensor:
    """Seeded noise blurred by three 7 x 7 box filters and scaled to [0, 1]
    per batch: a smooth field with blob-like level sets."""
    import torch.nn.functional as F

    x = torch.rand((b, 1, h, w), generator=gen)
    for _ in range(3):
        x = F.avg_pool2d(F.pad(x, (3, 3, 3, 3), mode="replicate"), 7, stride=1)
    x = x[:, 0]
    return (x - x.min()) / (x.max() - x.min())


def _flood_cases(gen: torch.Generator) -> dict[str, tuple]:
    """K3's ragged cases (dist, markers, mask on the CPU): seeded fields at
    2 x 40 x 56 and at 3 x 100 x 70 with min-index labels over 65,535, the
    1 x 100 strips where the 65-step cap binds (dist 1: at level 63, then
    level 62 grows the rest; dist 0: at the last level), and 2 x 512 x 512,
    whose planes do not fit in shared memory."""
    from path_gene_multimodal_tpu_torch.ops.components import INF

    def field(b, h, w, n, base):
        d = _smooth(gen, b, h, w)
        m = d > 0.15
        mk = torch.full((b, h, w), INF, dtype=torch.int32)
        for i in range(b):
            ys = torch.randint(0, h, (n,), generator=gen)
            xs = torch.randint(0, w, (n,), generator=gen)
            mk[i, ys, xs] = base + 1000 * torch.arange(1, n + 1, dtype=torch.int32)
        return d, torch.where(m, mk, INF), m

    cases = {"2x40x56": field(2, 40, 56, 6, 0), "3x100x70_min_index": field(3, 100, 70, 8, 70_000),
             "2x512x512_global_planes": field(2, 512, 512, 40, 0)}
    for name, v in (("strip_cap_level63", 1.0), ("strip_cap_level0", 0.0)):
        mk = torch.full((1, 1, 100), INF, dtype=torch.int32)
        mk[0, 0, 0] = 1
        cases[name] = (torch.full((1, 1, 100), v), mk, torch.ones((1, 1, 100), dtype=torch.bool))
    return cases


def _check_k3(dist, markers, blb, launches, failures) -> dict:
    """K3 on the main path's batch and on ragged cases against its plain
    version: labels and counts (steps summed and per tile, pixels grown)
    equal; three mutants must fail the same check; timings and the bound
    from the counted steps."""
    from path_gene_multimodal_tpu_torch.ops.flood import (
        FloodTiling, marker_watershed, marker_watershed_plain,
    )

    dev = dist.device
    new = lambda: torch.zeros(3, dtype=torch.int64, device=dev)  # noqa: E731
    cases = {"main_batch": (dist, markers, blb)}
    cases.update({k: tuple(t.to(dev) for t in v)
                  for k, v in _flood_cases(torch.Generator().manual_seed(30)).items()})
    expect = {"strip_cap_level63": [226, 226, 99], "strip_cap_level0": [192, 192, 65]}
    rec, worst, refs = {}, 0, {}
    with torch.inference_mode():
        for name, (d, mk, m) in cases.items():
            ck, cp = new(), new()
            a = marker_watershed(d, mk, m, counts=ck)
            p = marker_watershed_plain(d, mk, m, counts=cp)
            diff = int((a != p).sum())
            worst = max(worst, diff)
            refs[name] = (p, cp.tolist())
            rec[name] = {"shape": list(d.shape), "diff": diff, "counts": ck.tolist(),
                         "plain_counts": cp.tolist(),
                         "shared_planes": FloodTiling(*d.shape[1:]).shared}
            if diff or ck.tolist() != cp.tolist() or cp.tolist() != expect.get(name, cp.tolist()):
                failures.append(f"K3 {name}: {diff} labels differ from the plain version; counts "
                                f"{ck.tolist()}, plain {cp.tolist()}, expected {expect.get(name)}")
        if rec["2x512x512_global_planes"]["shared_planes"]:
            failures.append("K3: the 512 x 512 case kept its planes in shared memory")
        mutants = {}
        for kind in ("gauss_seidel", "no_fresh", "cap64"):
            caught = []
            for name, (d, mk, m) in cases.items():
                ml, mc = _flood_mutant(d, mk, m, kind)
                if bool((ml != refs[name][0]).any()) or mc.tolist() != refs[name][1]:
                    caught.append(name)
            mutants[kind] = caught
            if not caught:
                failures.append(f"K3: the {kind} mutant passes the check on every case")
        ms = _sync_time(lambda: marker_watershed(dist, markers, blb), reps=5)
        pms = _sync_time(lambda: marker_watershed_plain(dist, markers, blb), reps=1)
    steps, steps_max, grown = rec["main_batch"]["counts"]
    b, h, w = dist.shape
    # per counted step and pixel: the eligibility test and the test of the
    # neighbours' activity; per grown pixel 8 neighbour label reads
    bnd, by = _bound_ms(b * h * w * 13, [(steps * h * w * 2 + grown * 8, PEAK_F32)])
    return {
        "name": "flood", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/flood.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/flood.py:131",
        "launches": launches["flood"], "max_abs_err": float(worst),
        "ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "note": f"({b},{h},{w}); counted steps {steps} (mean {steps / b:.1f}, max {steps_max} per "
                f"tile, {steps / (b * 2 * 64):.2f} per phase), {grown} pixels grown; operations "
                "bound: per counted step and pixel 2 tests (eligible, active neighbour), per grown "
                "pixel 8 label reads, at the f32 scalar rate; bytes 13 per pixel",
        "counts": {"steps": steps, "steps_max_per_tile": steps_max, "grown": grown},
        "cases": rec, "mutants_caught_on": mutants,
    }


def _k2_cases(gen: torch.Generator) -> dict[str, torch.Tensor]:
    """K2's ragged cases (masks on the CPU): seeded blobs at 3 x 100 x 70,
    ``_spiral(256)``, the serpentine of 17 passes and two staircases that
    need more than the 257 passes of the cap."""
    s = torch.zeros((1, 32, 32), dtype=torch.bool)
    for r in range(0, 32, 2):
        s[0, r, :] = True
        s[0, min(r + 1, 31), 31 if (r // 2) % 2 == 0 else 0] = True
    st = torch.zeros((1, 160, 400), dtype=torch.bool)
    for i in range(160):
        st[0, i, i : i + 2] = True
        st[0, 159 - i, 161 + i : 163 + i] = True
    blobs = _smooth(gen, 3, 100, 70)
    return {"3x100x70": blobs > blobs.flatten(1).median(1).values[:, None, None],
            "spiral_256": torch.from_numpy(_spiral(256))[None], "serpentine_32": s,
            "staircases_160x400": st}


def _check_k2(fg, mmask, launches, failures) -> dict:
    """K2 on the main path's two masks (adaptive calls at the default
    budgets and at budgets around the batch's median root count, under
    which the gated re-run fires and tiles overflow) and on ragged cases
    against its plain version: labels, sizes, dense ids, n_roots or
    overflow, and pass counts equal; the late-segment mutant must fail the
    same check; timings and the bound from the counted passes."""
    from path_gene_multimodal_tpu_torch.ops.cc_sizes import (
        CcSizesTiling, cc_sizes, cc_sizes_adaptive, cc_sizes_adaptive_plain, cc_sizes_plain,
    )

    dev = fg.device
    new = lambda: torch.zeros(2, dtype=torch.int64, device=dev)  # noqa: E731
    worst, rec, overflow = 0, {}, {}

    def compare(name, kernel, plain, *args, **kw):
        nonlocal worst
        ck, cp = new(), new()
        a, p = kernel(*args, counts=ck, **kw), plain(*args, counts=cp, **kw)
        diff = max(int((x.long() != y.long()).sum()) for x, y in zip(a, p))
        worst = max(worst, diff)
        rec[name] = {"shape": list(args[0].shape), "diff": diff, "counts": ck.tolist(), **kw}
        if diff or ck.tolist() != cp.tolist():
            failures.append(f"K2 {name}: {diff} values differ from the plain version; counts "
                            f"{ck.tolist()}, plain {cp.tolist()}")
        return p, cp.tolist()

    with torch.inference_mode():
        big = int(cc_sizes_plain(fg)[3].median())
        budgets = {"default": (512, 4096), "median": (max(1, big // 4), big)}
        for mname, m, ms_ in (("fg", fg, 0), ("markers", mmask, 3)):
            for key, (small_, big_) in budgets.items():
                p, _ = compare(f"{mname}_{key}", cc_sizes_adaptive, cc_sizes_adaptive_plain, m,
                               min_size=ms_, small=small_, big=big_)
                overflow[f"{mname}_{key}"] = int(p[3].sum())
        if not 0 < overflow["fg_median"] < len(fg):
            failures.append(f"K2: median budgets {budgets['median']} left the overflow flags "
                            f"all equal ({overflow})")
        ragged = _k2_cases(torch.Generator().manual_seed(31))
        for name, m in ragged.items():
            compare(name, cc_sizes, cc_sizes_plain, m.to(dev), s_slots=512, min_size=3)
        for name, want in (("serpentine_32", [17, 17]), ("staircases_160x400", [257, 257])):
            if rec[name]["counts"] != want:
                failures.append(f"K2 {name}: counts {rec[name]['counts']}, expected {want}")
        caught = []
        masks = [("fg", fg), ("markers", mmask)] + [(k, v.to(dev)) for k, v in ragged.items()]
        for name, m in masks:
            cp = new()
            lbl = cc_sizes_plain(m, counts=cp)[0]
            ml, mc = _cc_late_mutant(m, CcSizesTiling(*m.shape[1:], 512).seg_len)
            if bool((ml != lbl).any()) or mc.tolist() != cp.tolist():
                caught.append(name)
        if not caught:
            failures.append("K2: the late-segment mutant passes the check on every case")
        fired = bool((cc_sizes_plain(fg, 512)[3] > 512).any())
        ms = _sync_time(lambda: cc_sizes_adaptive(fg), reps=10)
        pms = _sync_time(lambda: cc_sizes_adaptive_plain(fg), reps=1)
    passes, passes_max = rec["fg_default"]["counts"]
    b, h, w = fg.shape
    runs = 2 if fired else 1
    # per counted pass two run-minimum scans over the tile, at the scalar
    # rate; bytes: the mask in and three int32 maps out per relaxation run
    bnd, by = _bound_ms(runs * b * h * w * 13, [(passes * h * w * 2, PEAK_F32)])
    m_passes, m_max = rec["markers_default"]["counts"]
    return {
        "name": "cc_sizes", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/cc_sizes.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/cc_sizes.py:174",
        "launches": launches["cc_sizes"], "max_abs_err": float(worst),
        "ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "note": f"one cc_sizes_adaptive call (512-slot launch + gated 4096-slot launch, which "
                f"{'ran' if fired else 'returned at once'}) on the ({b},{h},{w}) foreground; 2 "
                f"calls per batch; counted passes {passes} (max {passes_max} per tile; the marker "
                f"masks {m_passes}, max {m_max}); bound: bytes 13 per pixel per relaxation run, "
                "2 run-min scans per pixel per counted pass; also checked at budgets "
                f"{budgets['median']}, overflow tiles {overflow}",
        "counts": {"passes_fg": passes, "passes_max_fg": passes_max, "passes_markers": m_passes,
                   "passes_max_markers": m_max},
        "cases": rec, "mutant_caught_on": caught,
    }


def _k4_continuation(li: torch.Tensor, slots: int, geo) -> torch.Tensor:
    """The pixels of K4's run pieces that continue a run of the lane before
    in the same warp (``csrc/instance_stats.cu``): a span that does not
    start a row nor a warp's 32 spans, whose first pixel has the id (in [1,
    S)) of the pixel before it, from its start to its first change of id.
    (B, H, W) bool."""
    import torch.nn.functional as F

    b, h, w = li.shape
    span, spr = geo.span, geo.spans_per_row
    ids = torch.where((li >= 0) & (li < slots), li, -1)
    ids = F.pad(ids, (0, spr * span - w), value=-1)
    eq = ids == F.pad(ids, (1, 0), value=-1)[..., :-1]
    y = torch.arange(h, device=li.device)  # a row's place among its block's rows
    place = (y // geo.band) // geo.cluster * geo.band + y % geo.band
    item = place[:, None] * spr + torch.arange(spr, device=li.device)[None, :]
    cont = (torch.arange(spr, device=li.device) > 0)[None, :] & (item % 32 > 0)  # (h, spr)
    eq = eq.reshape(b, h, spr, span)
    first = eq[..., 0] & (ids.reshape(b, h, spr, span)[..., 0] > 0) & cont
    run = torch.cat([first[..., None], eq[..., 1:]], dim=-1).long().cumprod(-1).bool()
    return run.reshape(b, h, spr * span)[..., :w]


def _k4_mutant(li, ti, slots: int, num_types: int, kind: str, geo):
    """A mutant of K4's design that the bit-equality check must catch, from
    the plain version on masked labels (-1 ids are ignored):
    ``"lane_double"`` counts the run pieces that continue a run across a
    lane boundary twice (once in the joined run, once alone);
    ``"head_extrema"`` takes each joined run's extrema from its head lane's
    piece only (xmax stops at the head lane's span); ``"rank_unmerged"``
    never adds rank 1's table into the slots the other ranks own. Returns
    (sums, mins)."""
    from path_gene_multimodal_tpu_torch.ops.instance_stats import instance_stats_plain

    sums, mins = instance_stats_plain(li, ti, slots, num_types)
    if kind == "rank_unmerged":
        y = torch.arange(li.shape[1], device=li.device)[None, :, None]
        owner = torch.clamp(li, 0, slots - 1) // geo.owner_chunk
        drop = ((y // geo.band) % geo.cluster == 1) & (owner != 1)
        return instance_stats_plain(torch.where(drop, -1, li), ti, slots, num_types)
    cont = _k4_continuation(li, slots, geo)
    if kind == "lane_double":
        extra, _ = instance_stats_plain(torch.where(cont, li, -1), ti, slots, num_types)
        return sums + extra, mins
    if kind == "head_extrema":
        _, head = instance_stats_plain(torch.where(cont, -1, li), ti, slots, num_types)
        mins = mins.clone()
        mins[:, 2] = head[:, 2]
        return sums, mins
    raise ValueError(kind)


def _k4_cases(gen: torch.Generator, dev) -> dict[str, tuple]:
    """K4's cases beyond the path batch: (labels, types, slots, num_types)."""
    def blobs(b, h, w, n, max_id, num_types):
        """n random boxes a tile, each one id in [1, max_id) and one type
        (a few pixels another), on background."""
        li = torch.zeros((b, h, w), dtype=torch.int32)
        ti = torch.randint(0, num_types, (b, h, w), generator=gen, dtype=torch.int32)
        for i in range(b):
            ys = torch.randint(0, h, (n, 2), generator=gen).sort(1).values
            xs = torch.randint(0, w, (n, 2), generator=gen).sort(1).values
            ids = torch.randint(1, max_id, (n,), generator=gen, dtype=torch.int32)
            tys = torch.randint(0, num_types, (n,), generator=gen, dtype=torch.int32)
            for (y0, y1), (x0, x1), k, t in zip(ys.tolist(), xs.tolist(), ids, tys):
                li[i, y0 : y1 + 1, x0 : x1 + 1] = k
                keep = ti[i, y0 : y1 + 1, x0 : x1 + 1]
                ti[i, y0 : y1 + 1, x0 : x1 + 1] = torch.where(keep % 7 == 0, keep, t)
        return li, ti

    def runs(b, h, w, max_len, lo, hi):
        """Rows of runs of 1..max_len pixels, each a random id in [lo, hi)."""
        n = h * w
        lens = torch.randint(1, max_len + 1, (b * n,), generator=gen)
        ids = torch.randint(lo, hi, (b * n,), generator=gen, dtype=torch.int32)
        return torch.repeat_interleave(ids, lens)[: b * n].reshape(b, h, w)

    s = 512
    cases = {
        "ragged_3x100x70": (*blobs(3, 100, 70, 40, s, 6), s, 6),
        "whole_tile_1x224x224": (torch.ones((1, 224, 224), dtype=torch.int32),
                                 torch.randint(0, 6, (1, 224, 224), generator=gen,
                                               dtype=torch.int32), s, 6),
        "background_2x224x224": (torch.zeros((2, 224, 224), dtype=torch.int32),
                                 torch.randint(0, 6, (2, 224, 224), generator=gen,
                                               dtype=torch.int32), s, 6),
        "runs_2x64x1004": (runs(2, 64, 1004, 400, 0, s), torch.randint(
            0, 6, (2, 64, 1004), generator=gen, dtype=torch.int32), s, 6),
        "outside_ids_2x96x96": (runs(2, 96, 96, 12, -40, s + 200), torch.randint(
            -2, 9, (2, 96, 96), generator=gen, dtype=torch.int32), s, 6),
        "over_512_1x224x224": (*blobs(1, 224, 224, 1500, 1400, 6), s, 6),
        "types_2_3x224x224": (*blobs(3, 224, 224, 150, s, 2), s, 2),
        "types_9_1x224x224": (*blobs(1, 224, 224, 150, s, 9), s, 9),
        "slots_64_2x56x40": (*blobs(2, 56, 40, 30, 80, 6), 64, 6),
    }
    # whole rows of one id on narrow tiles (32-bit sums): a slot's run over
    # a row is longer than a warp's 256 px, and its moment formed in one
    # piece would pass 2^31 before its division; the table's sum does not
    for b, h, w in ((2, 1, 1500), (1, 5, 1025)):
        rows = torch.randint(1, s, (b, h, 1), generator=gen, dtype=torch.int32)
        cases[f"row_runs_{b}x{h}x{w}"] = (rows.expand(b, h, w).contiguous(), torch.randint(
            0, 6, (b, h, w), generator=gen, dtype=torch.int32), s, 6)
    yy, xx = torch.meshgrid(torch.arange(224), torch.arange(224), indexing="ij")
    alt = (1 + xx % 2 + 2 * (yy % 3)).to(torch.int32)[None].repeat(3, 1, 1)
    cases["alternating_3x224x224"] = (alt, torch.randint(0, 6, (3, 224, 224), generator=gen,
                                                         dtype=torch.int32), s, 6)
    return {k: (li.to(dev), ti.to(dev), sl, nt) for k, (li, ti, sl, nt) in cases.items()}


def _bit_equal(a: tuple, b: tuple) -> bool:
    """(sums, mins) pairs equal bit for bit."""
    return all(torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


def _check_k4(li, ti, slots, launches, failures) -> dict:
    """K4 against its plain version, bit for bit in both outputs: on the
    path batch, on ``_k4_cases`` and at the cluster sizes on either side of
    the chosen one (timed too); the three design mutants must differ; a
    spill in the kernel fails the run."""
    from path_gene_multimodal_tpu_torch.ops import cuda
    from path_gene_multimodal_tpu_torch.ops import instance_stats as k4

    dev = li.device
    nt = 6
    geo = k4.tiling(*li.shape, slots, nt, cuda.sm_count(dev))
    with torch.inference_mode():
        got = k4.instance_stats(li, ti, slots, nt)
        want = k4.instance_stats_plain(li, ti, slots, nt)
        err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        if not _bit_equal(got, want):
            failures.append(f"K4 on the path batch: kernel and plain differ (max {err:.3g})")
        ms = _sync_time(lambda: k4.instance_stats(li, ti, slots, nt), reps=50)
        device_ms = _queued_ms(lambda: k4.instance_stats(li, ti, slots, nt), reps=50)
        pms = _sync_time(lambda: k4.instance_stats_plain(li, ti, slots, nt), reps=2)
        other = {}
        for kk in (geo.cluster // 2, geo.cluster * 2):
            if kk not in k4.CLUSTERS:
                continue
            alt = next(g for g in (k4.InstanceStatsTiling(*li.shape, slots, nt, sms)
                                   for sms in range(1, 4096)) if g.cluster == kk)
            out = (torch.empty_like(got[0]), torch.empty_like(got[1]))
            k4._launch(li, ti, *out, alt)
            if not _bit_equal(out, want):
                failures.append(f"K4 on clusters of {kk}: kernel and plain differ")
            other[kk] = _queued_ms(lambda: k4._launch(li, ti, *out, alt), reps=50)
        mutants = {kind: not _bit_equal(_k4_mutant(li, ti, slots, nt, kind, geo), want)
                   for kind in ("lane_double", "head_extrema", "rank_unmerged")}
        for kind, seen in mutants.items():
            if not seen:
                failures.append(f"K4: the bit-equality check does not see the {kind} mutant")
        cases = []
        for name, (cl, ct, sl, cn) in _k4_cases(torch.Generator().manual_seed(44), dev).items():
            before = k4.instance_stats.launches
            g2 = k4.instance_stats(cl, ct, sl, cn)
            ok = _bit_equal(g2, k4.instance_stats_plain(cl, ct, sl, cn))
            cg = k4.tiling(*cl.shape, sl, cn, cuda.sm_count(dev))
            cases.append({"case": name, "shape": list(cl.shape), "slots": sl, "num_types": cn,
                          "cluster": cg.cluster, "vector_rows": cg.vector_rows,
                          "live_slots": int((g2[0][..., 0] > 0).sum()), "bit_equal": ok})
            if not ok:
                failures.append(f"K4 case {name}: kernel and plain differ")
            if k4.instance_stats.launches - before != 1:
                failures.append(f"K4 case {name}: {k4.instance_stats.launches - before} launches")
        bsz, h, w = li.shape
        idx = (li.long() + torch.arange(bsz, device=dev)[:, None, None] * slots).reshape(-1)
        pix = torch.arange(h * w, device=dev)
        x_, y_ = (pix % w).float().repeat(bsz), (pix // w).float().repeat(bsz)
        dx_, dy_ = x_ - w / 2, y_ - h / 2
        tpf = ti.reshape(-1)
        vals = torch.stack([torch.ones_like(x_), x_, y_, dx_ * dx_, dy_ * dy_, dx_ * dy_]
                           + [(tpf == t).float() for t in range(1, nt)], dim=1)
        acc = torch.zeros((bsz * slots, vals.shape[1]), device=dev)
        lms = _sync_time(lambda: acc.index_add_(0, idx, vals), reps=20)
    ptxas = _ptxas_entries(cuda.build_log("instance_stats"))
    for entry, info in ptxas.items():
        if info.get("spill_stores", 0) or info.get("spill_loads", 0):
            failures.append(f"K4: {entry} spills ({info})")
    nbytes = li.numel() * 8 + got[0].numel() * 4 + got[1].numel() * 4
    bnd, by = _bound_ms(nbytes, [(li.numel() * 12, PEAK_F32)])
    return {
        "name": "instance_stats", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/instance_stats.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/instance_stats.py:123",
        "launches": launches["instance_stats"], "max_abs_err": err,
        "ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by, "library_ms": lms,
        "note": f"{tuple(li.shape)} int32, S={slots}, {nt} types: sums and mins bit-equal to "
                "the plain version; ms: calls back to back through the wrapper, as for every "
                "kernel; device_ms: the same calls queued behind a sleep kernel (device time, "
                "the wrapper's host path excluded; ms_other_cluster is timed so too); "
                "library_ms: index_add_ of the (pixels, 11) value matrix (sums only, no bbox "
                "extrema)",
        "device_ms": device_ms,
        "geometry": {"cluster": geo.cluster, "band": geo.band, "threads": geo.threads,
                     "span": geo.span, "vector_rows": geo.vector_rows,
                     "smem_bytes": geo.smem_bytes, "owner_chunk": geo.owner_chunk},
        "ms_other_cluster": other, "mutants_differ": mutants, "cases": cases, "ptxas": ptxas,
        "live_slots": int((got[0][..., 0] > 0).sum()),
    }


def _spiral(n: int) -> np.ndarray:
    """A 1-px square spiral with 1-px gaps between its arms: its labels need
    about one relaxation per turn, so small caps bind."""
    m = np.zeros((n, n), bool)
    y = x = d = turns = 0
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    m[0, 0] = True
    while turns < 2:
        dy, dx = dirs[d]
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        if (0 <= ny < n and 0 <= nx < n and not m[ny, nx]
                and not (0 <= ay < n and 0 <= ax < n and m[ay, ax])):
            y, x, turns = ny, nx, 0
            m[y, x] = True
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def _line_mask(n: int, seed: int) -> np.ndarray:
    """Random foreground (30%) with full-length lines every 600 px and a
    serpentine over the corner of four 512-px tiles: components that cross
    every tile border."""
    m = np.random.default_rng(seed).random((n, n)) < 0.3
    for k in range(100, n, 600):
        m[k, :] = True
        m[:, min(k + 100, n - 1)] = True
    for i, r in enumerate(range(400, 640, 4)):
        m[r, 380:660] = True
        c = 659 if i % 2 == 0 else 380
        m[r : r + 5, c] = True
    return m


def _cc_bound(px: int, relaxes: int, tile_px: int, rounds: int, conn: int):
    """K5/K6 bound: the mask in (1 byte) and the labels out (4 bytes) per
    pixel; per relaxation and tile pixel 4 integer minima (row and column
    runs, each way) + 4 diagonal ones at connectivity 2; per border-min
    exchange (every round after the first) and pixel 4 or 8 neighbour
    minima; at the scalar rate."""
    per_px = 4 if conn == 1 else 8
    return _bound_ms(5 * px, [(relaxes * tile_px * per_px + max(rounds - 1, 0) * px * per_px,
                               PEAK_F32)])


def _islands(slide, tmp, wrappers, report, failures):
    """Section 7: the islands path at the real thumbnail size, at
    max_work_dim 1024 and 2048. Returns the three masks the path hands K5
    (max_work_dim 1024) and the launch counts of the 1024 run."""
    from path_gene_multimodal_tpu_torch.core.artifacts import export_geojson
    from path_gene_multimodal_tpu_torch.ops import cc
    from path_gene_multimodal_tpu_torch.pipeline import morphology as morph

    t0 = time.perf_counter()
    thumb = slide.get_thumbnail(THUMB)
    thumb_s = time.perf_counter() - t0
    scale = slide.level_dimensions[0][0] / thumb.shape[1]
    # a first run records the masks the path hands K5 and gives the tissue
    # rings the islands GeoJSON is made of
    seen, orig = [], cc.label_components_tiled

    def record(mask, *a, **k):
        seen.append(mask.clone())
        return orig(mask, *a, **k)

    record.launches = 0  # K5's wrapper counts into the name it is called by
    cc.label_components_tiled = morph.label_components_tiled = record
    try:
        mask = morph.tissue_boundary_mask(thumb)
        rings = morph.mask_to_thumb_polygons(mask)
    finally:
        cc.label_components_tiled = morph.label_components_tiled = orig
    # islands: the tissue cut by a 250-px grid of 3-px lines into pieces,
    # their classes taken in turn from ISLAND_CLASSES
    cut = mask.copy()
    for k in range(0, max(cut.shape), 250):
        cut[k : k + 3, :] = False
        cut[:, k : k + 3] = False
    pieces = morph.mask_to_thumb_polygons(cut)
    feats = [{"class_name": ISLAND_CLASSES[i % 4], "exterior": r * scale}
             for i, r in enumerate(pieces)]
    gj = export_geojson(tmp / "islands.geojson", feats)
    n_rows = sum(f["class_name"] != "Stroma" for f in feats)
    if len(seen) != 3 or not rings or len(pieces) < 8:
        failures.append(f"islands: {len(seen)} K5 calls, {len(rings)} tissue rings and "
                        f"{len(pieces)} islands on the first run, expected 3, >= 1 and >= 8")
    t0 = time.perf_counter()
    cpu_mask = morph.tissue_boundary_mask(thumb, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(cpu_mask, mask):
        failures.append(f"islands: the tissue mask differs between card and CPU in "
                        f"{int((cpu_mask != mask).sum())} pixels")

    runs, counts = {}, {}
    for dim in (1024, 2048):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with _cc_spy() as spy:
            df = morph.process_one_slide_make_csv_and_plot(
                slide, gj, tmp / f"islands_{dim}", f"islands_{dim}", ["Tumor"], ["TILs"], ["TLS"],
                thumb_size=THUMB, max_work_dim=dim)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[dim] = {n: w.launches for n, w in wrappers.items()}
        # K5's calls as its kernel saw them: the driver each ran, the rounds
        # it counted; a call is one launch (device rounds) or one a round
        k5 = [{"driver": "device" if c["device_rounds"] else "host", "rounds": int(c["counts"][1]),
               "cluster": c["geo"].n, "shape": c["shape"]} for c in spy.calls()]
        txt = morph.write_basic_size_burden_metrics_txt(df, "smoke", tmp / f"burden_{dim}.txt")
        png = tmp / f"islands_{dim}" / f"islands_{dim}_boundaries.png"
        num = df.drop(columns=["slide_id", "type"]).to_numpy(np.float64)
        tissue = float(df["tissue_area_px2"].iloc[0]) if len(df) else 0.0
        runs[dim] = {"s": dt, "rows": len(df), "tissue_area_px2": tissue,
                     "tissue_fraction": tissue / (slide.level_dimensions[0][0] ** 2),
                     "launches": counts[dim], "k5_calls": k5,
                     "png_bytes": png.stat().st_size if png.exists() else 0,
                     "burden_lines": len(txt.read_text().splitlines())}
        if len(df) != n_rows or not np.isfinite(num).all() or not tissue > 0:
            failures.append(f"islands {dim}: {len(df)} rows (expected {n_rows}), finite "
                            f"{bool(np.isfinite(num).all())}, tissue area {tissue}")
        if not png.exists() or png.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
            failures.append(f"islands {dim}: no PNG written")
        k5_launches = sum(1 if c["driver"] == "device" else c["rounds"] for c in k5)
        expect = {n: (k5_launches if n == "label_components_tiled" else 0) for n in wrappers}
        if counts[dim] != expect or len(k5) != 3:
            failures.append(f"islands {dim}: launches {counts[dim]}, expected {expect} from "
                            f"{len(k5)} K5 calls (expected 3): {k5}")
        print(f"islands max_work_dim={dim}: {dt:.3f} s, {len(df)} islands", flush=True)
    if runs[1024]["tissue_area_px2"] <= 0 or abs(
            runs[2048]["tissue_area_px2"] / runs[1024]["tissue_area_px2"] - 1) > 0.05:
        failures.append("islands: the tissue areas at max_work_dim 1024 and 2048 differ by "
                        "more than 5%")
    report["islands"] = {"thumbnail": list(thumb.shape), "thumbnail_s": thumb_s,
                         "cpu_tissue_mask_s": cpu_s, "tissue_rings": len(rings),
                         "islands": len(pieces), "runs": runs}
    return seen, counts[1024]


def _cc_band_mutant(mask, bh: int, kind: str, max_iters: int = 256):
    """A mutant of K6's banded relaxation (connectivity 1) that the
    label-and-count check must catch: ``"late"`` joins the column runs of
    bands of ``bh`` rows one pass late (``_cc_late_mutant`` with segments of
    a band), ``"cut"`` reads the band border as background (no run crosses
    it). Returns (labels, counts as the kernel's: relaxations, 1 round)."""
    from path_gene_multimodal_tpu_torch.ops.components import _run_min_lastdim, index_seeds

    if kind == "late":
        lbl, c = _cc_late_mutant(mask, bh, max_iters)
        return lbl, torch.stack([c[0], torch.ones_like(c[0])])
    import torch.nn.functional as F

    mask = mask.bool()
    b, h, w = mask.shape
    mt = mask.transpose(-1, -2).contiguous()
    pad = -h % bh
    mseg = F.pad(mt, (0, pad)).reshape(b, -1, bh)

    def relax(lbl):
        lbl = _run_min_lastdim(lbl, mask).transpose(-1, -2).contiguous()
        seg = _run_min_lastdim(F.pad(lbl, (0, pad), value=2**30).reshape(b, -1, bh), mseg)
        return seg.reshape(b, w, h + pad)[..., :h].transpose(-1, -2).contiguous()

    seeds = index_seeds(mask)
    lbl = relax(seeds)
    ch = (lbl != seeds).flatten(1).any(1)
    n = torch.ones(b, dtype=torch.int64, device=mask.device)
    it = 0
    while bool(ch.any()) and it < max_iters:
        new = relax(lbl)
        n += ch
        ch = (new != lbl).flatten(1).any(1)
        lbl, it = new, it + 1
    return lbl, torch.stack([n.sum(), torch.ones_like(n[0])])


class _cc_spy:  # noqa: N801 (a context manager, named as one)
    """The launches of K5/K6's core (``ops/cc.py::_launch``) while it is
    installed: each launch's geometry, round, driver, its flags tensor (the
    spy's own where the wrapper passes none; the kernel sets its last word
    to the cluster size it ran on) and counts tensor (the spy's own, one a
    call, where the wrapper passes none)."""

    def __enter__(self):
        from path_gene_multimodal_tpu_torch.ops import cc

        self.cc, self.orig, self.launches = cc, cc._launch, []
        cc._launch = self
        return self

    def __exit__(self, *exc):
        self.cc._launch = self.orig
        return False

    def __call__(self, m, lbl0, lbl1, flags, bar, counts, geo, b, h, w, *rest):
        rnd, device_rounds = rest[-2], rest[-1]
        if flags is None:
            flags = torch.zeros(4, dtype=torch.int32, device=m.device)
        if counts is None:  # a call starts at round 0; its rounds share one tensor
            counts = (torch.zeros(2, dtype=torch.int64, device=m.device)
                      if rnd == 0 or not self.launches else self.launches[-1]["counts"])
        self.launches.append({"geo": geo, "round": rnd, "device_rounds": bool(device_rounds),
                              "flags": flags, "counts": counts, "shape": [b, h, w]})
        self.orig(m, lbl0, lbl1, flags, bar, counts, geo, b, h, w, *rest)

    def calls(self) -> list[dict]:
        """One entry a call: its first launch's record."""
        return [r for r in self.launches if r["round"] == 0]


def _cc_ptxas(cuda) -> dict[str, dict]:
    """ptxas registers, stack and spills of ``csrc/cc.cu``'s kernels."""
    return _ptxas_entries(cuda.build_log("cc"))


def _k5_launch_times(mask) -> dict:
    """One K5 call's launches each timed on the device alone (queued behind
    a sleep kernel, so that CUDA events around a launch see neither the
    host's launch path nor its flag reads), the call's ms (events around a
    call run as the path runs it, median of 5) and the share of the call
    outside the launches (the host loop: flag reads and launch gaps)."""
    from path_gene_multimodal_tpu_torch.ops import cc

    orig, evs = cc._launch, []

    def timed(*a, **k):
        torch.cuda._sleep(1_000_000)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        orig(*a, **k)
        e1.record()
        evs.append((e0, e1))

    calls = []
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        cc.label_components_tiled(mask)
        end.record()
        torch.cuda.synchronize()
        calls.append(start.elapsed_time(end))
    call = sorted(calls[1:])[2]
    cc._launch = timed
    try:
        cc.label_components_tiled(mask)
        torch.cuda.synchronize()
    finally:
        cc._launch = orig
    launches = [a.elapsed_time(b) for a, b in evs]
    device_rounds = cc.k5_plan(*mask.shape, 512, mask.device)[1]
    return {"driver": "device" if device_rounds else "host", "launch_ms": launches,
            "call_ms": call, "host_share": max(0.0, 1 - sum(launches) / call)}


def _k5_call_on(m, geo):
    """One K5 call (connectivity 1, the path's caps) on geometry ``geo``,
    every round in one launch, through the core's launcher: the timing of a
    cluster size the geometry did not choose."""
    from path_gene_multimodal_tpu_torch.ops import cc

    h, w = m.shape
    lbl = torch.empty((2, h, w), dtype=torch.int32, device=m.device)
    state = torch.zeros(5, dtype=torch.int32, device=m.device)
    cc._launch(cc._mask_u8(m), lbl[0], lbl[1], state[:4], state[4:], None, geo, 1, h, w, 1, 128,
               64, 0, True)
    return lbl[0]  # after max_outer (even) rounds, as the wrapper returns


def _k6_call_on(m, geo):
    """One K6 call (connectivity 1) on geometry ``geo`` through the core's
    launcher."""
    from path_gene_multimodal_tpu_torch.ops import cc

    out = torch.empty(m.shape, dtype=torch.int32, device=m.device)
    cc._launch(cc._mask_u8(m), out, out, None, None, None, geo, *m.shape, 1, 256, 0, 0, False)
    return out


def _k5_concurrent(masks, want, streams: int = 4) -> dict:
    """K5's device-rounds driver on ``streams`` streams at once, each
    stream's calls queued behind a sleep kernel so that they start
    together: more blocks than the card holds ask for a grid barrier at
    once. The cooperative launch must keep each grid whole (no trap) and
    every label must equal ``want``."""
    from path_gene_multimodal_tpu_torch.ops.cc import label_components_tiled

    ss = [torch.cuda.Stream() for _ in range(streams)]
    torch.cuda.synchronize()
    outs = []
    t0 = time.perf_counter()
    for s in ss:
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
            outs.append([label_components_tiled(m) for m in masks])
    torch.cuda.synchronize()
    return {"streams": streams, "s": time.perf_counter() - t0,
            "diff": sum(int((a != b).sum()) for o in outs for a, b in zip(o, want))}


def _check_cc(path_masks, fg, path_launches, wrappers, failures, out_dir) -> list[dict]:
    """Section 8: K5 and K6 against their plain versions (labels and counts
    in every case; the clusters they ran on, their bands in shared memory
    on the path's masks, both of K5's round drivers as the geometry chooses
    them, global bands at tile 1024 and on 12,000-px rows, the device driver
    on four streams at once, mutants of the banded design that must fail
    the same check); launch times, the cluster size the geometry did not
    choose; ptxas (a spill fails the run). Returns their entries of the
    JSON line."""
    from path_gene_multimodal_tpu_torch.ops import cuda
    from path_gene_multimodal_tpu_torch.ops.cc import (
        CcTiling, label_components_batch, label_components_batch_plain, label_components_tiled,
        label_components_tiled_plain,
    )
    from path_gene_multimodal_tpu_torch.ops.cc_sizes import cc_sizes_adaptive

    dev = fg.device
    src = "path_gene_multimodal_tpu_torch/csrc/cc.cu"
    pallas = "path_gene_multimodal_tpu/ops/pallas/cc.py"
    new_counts = lambda: torch.zeros(2, dtype=torch.int64, device=dev)  # noqa: E731
    entries = []
    torch.save({"path_masks": [m.cpu() for m in path_masks], "fg": fg.cpu()},
               out_dir / "cc_inputs.pt")
    ptxas = _cc_ptxas(cuda)
    spills = {k: v for k, v in ptxas.items() if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    if not ptxas or spills:
        failures.append(f"cc: ptxas lines {ptxas}; spills {spills}")

    def compare(kernel, plain, m, conn, **kw):
        ck, cp = new_counts(), new_counts()
        with _cc_spy() as spy:
            a = kernel(m, conn, counts=ck, **kw)
        p = plain(m, conn, counts=cp, **kw)
        geo = spy.launches[0]["geo"]
        seen = {int(r["flags"][3]) for r in spy.launches}
        rec = {"shape": list(m.shape), "connectivity": conn, "relaxes": int(ck[0]),
               "rounds": int(ck[1]), "diff": int((a != p).sum()), **kw, "cluster": geo.n,
               "cluster_seen": sorted(seen), "band_in_shared": geo.shared,
               "launches": len(spy.launches),
               "driver": ("single" if kernel is label_components_batch else
                          "device" if spy.launches[0]["device_rounds"] else "host")}
        if rec["diff"] or ck.tolist() != cp.tolist():
            failures.append(f"{kernel.__name__} {rec}: {rec['diff']} labels differ from the plain "
                            f"version; counts {ck.tolist()} vs plain {cp.tolist()}")
        if seen != {geo.n}:
            failures.append(f"{kernel.__name__} {rec}: ran on clusters of {sorted(seen)}, "
                            f"CcTiling names {geo.n}")
        if rec["driver"] == "host" and rec["launches"] != rec["rounds"]:
            failures.append(f"{kernel.__name__} {rec}: {rec['launches']} launches for "
                            f"{rec['rounds']} rounds of the host driver")
        return a, rec

    # K5: the path's masks, a 2048^2 mask crossing every tile border (tile
    # 512: the host driver, its 16 clusters of 8 do not fit at once; 1024:
    # global bands; 128: 256 tiles), a capped spiral, the device driver on
    # four streams at once
    cases = []
    with torch.inference_mode():
        for i, m in enumerate(path_masks):
            cases.append(compare(label_components_tiled, label_components_tiled_plain, m, 1)[1])
            cases[-1]["mask"] = f"path_{i}"
            if not cases[-1]["band_in_shared"]:
                failures.append(f"K5 path_{i}: its bands are not in shared memory")
        lines = torch.from_numpy(_line_mask(2048, seed=5)).to(dev)
        for conn in (1, 2):
            for tile in (512, 1024, 128):
                cases.append(compare(label_components_tiled, label_components_tiled_plain, lines,
                                     conn, **({"tile": tile} if tile != 512 else {}))[1])
                cases[-1]["mask"] = "lines_2048"
        sp = torch.from_numpy(_spiral(768)).to(dev)
        capped, rec = compare(label_components_tiled, label_components_tiled_plain, sp, 1,
                              tile=256, max_iters=16, max_outer=3)
        rec["mask"] = "spiral_768"
        rec["caps_bind"] = not torch.equal(capped, label_components_tiled(sp, 1, tile=256))
        cases.append(rec)
        if not rec["caps_bind"]:
            failures.append("K5: the capped spiral equals its uncapped labels: the caps do not bind")
        if not any(c.get("tile") == 1024 and not c["band_in_shared"] for c in cases):
            failures.append("K5: no case ran with its bands in global memory")
        for drv in ("host", "device"):
            if not any(c["driver"] == drv for c in cases):
                failures.append(f"K5: the geometry chose the {drv} driver on no case")
        want = [label_components_tiled_plain(m) for m in path_masks]
        concurrent = _k5_concurrent(path_masks, want)
        if concurrent["diff"]:
            failures.append(f"K5: the device driver on {concurrent['streams']} streams at once: "
                            f"{concurrent['diff']} labels differ from the plain version")
        ms = _sync_time(lambda: [label_components_tiled(m) for m in path_masks], reps=5)
        pms = _sync_time(lambda: [label_components_tiled_plain(m) for m in path_masks], reps=1)
        ms_lines = _sync_time(lambda: label_components_tiled(lines), reps=3)
        # the cluster size the geometry did not choose (8 where it names 16)
        chosen = next(c["cluster"] for c in cases if c["mask"] == "path_0")
        alt = CcTiling(512, 512, tiles=16 if chosen == 16 else 4, sms=cuda.sm_count(dev))
        alt_diff = sum(int((_k5_call_on(m, alt) != p).sum()) for m, p in zip(path_masks, want))
        alt_ms = _sync_time(lambda: [_k5_call_on(m, alt) for m in path_masks], reps=5)
        if alt_diff:
            failures.append(f"K5 on clusters of {alt.n}: {alt_diff} labels differ")
        launch_times = {f"path_{i}": _k5_launch_times(m) for i, m in enumerate(path_masks)}
        launch_times["lines_2048"] = _k5_launch_times(lines)
        del lines, sp, capped
    path = [c for c in cases if c["mask"].startswith("path_")]
    px = sum(m.numel() for m in path_masks)
    bnd, by = _cc_bound(px, sum(c["relaxes"] for c in path), 512 * 512,
                        sum(c["rounds"] for c in path), 1)
    entries.append({
        "name": "label_components_tiled", "route": "cuda", "source": src,
        "replaces": f"{pallas}:146", "launches": path_launches["label_components_tiled"],
        "max_abs_err": float(max(c["diff"] for c in cases)), "ms": ms, "plain_ms": pms,
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "note": "per slide: the islands path's 3 calls on its 1024^2 masks (max_work_dim 1024), "
                f"clusters of {path[0]['cluster']}, {path[0]['driver']} driver; bound from this "
                f"run's relaxation and round counts; the 2048^2 lines mask: {ms_lines:.3f} ms per "
                "call; labels and counts equal to the plain version on every case",
        "per_call": [{k: c[k] for k in ("mask", "relaxes", "rounds", "cluster", "driver")}
                     for c in path],
        "ms_other_cluster": {"cluster": alt.n, "ms": alt_ms}, "launch_times": launch_times,
        "concurrent": concurrent, "ptxas": ptxas, "cases": cases,
    })

    # K6: the nuclei batch's foreground masks, seeded and ragged masks
    gen = np.random.default_rng(6)
    rnd = torch.from_numpy(gen.random((64, 256, 256)) < 0.5).to(dev)
    ragged = {"ragged_3x100x70": torch.from_numpy(gen.random((3, 100, 70)) < 0.55).to(dev),
              "ragged_2x512x512": torch.from_numpy(
                  (gen.random((2, 512, 512)) < 0.5) | _spiral(512)[None]).to(dev),
              "wide_2x8x12000": torch.from_numpy(gen.random((2, 8, 12_000)) < 0.6).to(dev)}
    cases = []
    with torch.inference_mode():
        for conn in (1, 2):
            for name, m in (("nuclei_fg", fg), ("seeded", rnd), *ragged.items()):
                a, rec = compare(label_components_batch, label_components_batch_plain, m, conn)
                rec["mask"] = name
                if conn == 1 and name == "nuclei_fg":
                    rec["diff_vs_k2"] = int((a != cc_sizes_adaptive(m)[0]).sum())
                    if rec["diff_vs_k2"]:
                        failures.append(f"K6: {rec['diff_vs_k2']} labels differ from K2's")
                cases.append(rec)
        if not any(c["mask"].startswith("wide") and not c["band_in_shared"] for c in cases):
            failures.append("K6: the 12,000-px rows did not run with their bands in global memory")
        # the banded design's mutants must fail the same check somewhere
        caught = {}
        for kind in ("late", "cut"):
            caught[kind] = []
            for name, m in (("nuclei_fg", fg), ("seeded", rnd[:8]), *ragged.items()):
                cp = new_counts()
                lbl = label_components_batch_plain(m, 1, counts=cp)
                bh = CcTiling(*m.shape[1:], tiles=m.shape[0], sms=cuda.sm_count(dev)).bh
                ml, mc = _cc_band_mutant(m, bh, kind)
                if bool((ml != lbl).any()) or mc.tolist() != cp.tolist():
                    caught[kind].append(name)
            if not caught[kind]:
                failures.append(f"K6: the {kind} band mutant passes the check on every case")
        # K6 has no pipeline caller: its path is its entry point on the masks
        for w in wrappers.values():
            w.launches = 0
        label_components_batch(fg)
        torch.cuda.synchronize()
        k6_launches = {n: w.launches for n, w in wrappers.items()}
        ms = _sync_time(lambda: label_components_batch(fg), reps=10)
        pms = _sync_time(lambda: label_components_batch_plain(fg), reps=1)
        fg1 = cases[0]
        # the cluster size the geometry did not choose (4 where it names 2)
        alt = CcTiling(*fg.shape[1:], tiles=32 if fg1["cluster"] == 2 else fg.shape[0],
                       sms=cuda.sm_count(dev))
        alt_diff = int((_k6_call_on(fg, alt) != label_components_batch(fg)).sum())
        alt_ms = _sync_time(lambda: _k6_call_on(fg, alt), reps=10)
        if alt_diff:
            failures.append(f"K6 on clusters of {alt.n}: {alt_diff} labels differ")
    if k6_launches["label_components_batch"] != 1 or sum(k6_launches.values()) != 1:
        failures.append(f"K6 entry point: launches {k6_launches}")
    bnd, by = _cc_bound(fg.numel(), fg1["relaxes"], fg.shape[1] * fg.shape[2], 0, 1)
    entries.append({
        "name": "label_components_batch", "route": "cuda", "source": src,
        "replaces": f"{pallas}:112", "launches": k6_launches["label_components_batch"],
        "max_abs_err": float(max(c["diff"] for c in cases)), "ms": ms, "plain_ms": pms,
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "note": f"one call on the nuclei batch's {tuple(fg.shape)} foreground masks, connectivity "
                f"1, clusters of {fg1['cluster']}; no pipeline caller (as in the JAX package): "
                "launches from one call of its entry point; labels equal to the plain version "
                "and (connectivity 1) to K2's",
        "ms_other_cluster": {"cluster": alt.n, "ms": alt_ms}, "mutant_caught_on": caught,
        "cases": cases,
    })
    return entries


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="directory for chip_smoke.json and scratch files")
    ap.add_argument("--ab", type=Path, metavar="PARENT",
                    help="only time K1-K11 of the package copy under PARENT "
                         "against this checkout's (after a main run with the same --out)")
    ap.add_argument("--ab-child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out_dir = args.out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.ab_child is not None:
        return _ab_child(args.ab_child, args.check, args.inputs)
    if args.ab is not None:
        return _ab(args.ab, out_dir)

    import pandas as pd

    from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY, default_config
    from path_gene_multimodal_tpu_torch.io.slide import synthetic_wsi
    from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt, init_weights, tta_forward
    from path_gene_multimodal_tpu_torch.ops import cc, cuda
    from path_gene_multimodal_tpu_torch.ops import watershed as ws
    from path_gene_multimodal_tpu_torch.ops.cc_sizes import cc_sizes, cc_sizes_adaptive
    from path_gene_multimodal_tpu_torch.ops.components import INF
    from path_gene_multimodal_tpu_torch.ops.convnext_block import (
        convnext_block, convnext_block_plain,
    )
    from path_gene_multimodal_tpu_torch.ops import decoder as dec
    from path_gene_multimodal_tpu_torch.ops.flood import marker_watershed
    from path_gene_multimodal_tpu_torch.ops.instance_stats import instance_stats
    from path_gene_multimodal_tpu_torch.ops.instances import instance_features_batch
    from path_gene_multimodal_tpu_torch.pipeline.nuclei import (
        NucleiModel, load_tile_annotations, run_hovernet_pipeline_on_wsi_tiles,
        select_tiles_for_hovernet,
    )
    from path_gene_multimodal_tpu_torch.utils.headfit import fit_heads, sample_tissue_tiles

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir.mkdir(parents=True, exist_ok=True)
    report: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": torch.cuda.get_device_name(0), "smi": _smi()}
    dev = torch.device("cuda")
    wrappers = {"convnext_block": convnext_block, "cc_sizes": cc_sizes,
                "flood": marker_watershed, "instance_stats": instance_stats,
                "decoder_conv": dec.decoder_conv, "final_conv_gelu": dec.final_conv_gelu,
                "upsample_final": dec.upsample_final, "final_heads": dec.final_heads,
                "composite_final_heads": dec.composite_final_heads,
                "label_components_tiled": cc.label_components_tiled,
                "label_components_batch": cc.label_components_batch}

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    cuda.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {n: [ln.strip() for ln in cuda.build_log(n).splitlines()
                           if "registers" in ln or "bytes stack" in ln]
                       for n in cuda.KERNELS}
    print(f"built {len(cuda.KERNELS)} kernels in {report['build_s']:.1f} s", flush=True)
    print(json.dumps({"ptxas_upsample_conv": report["ptxas"]["upsample_conv"],
                      "ptxas_conv64": report["ptxas"]["conv64"],
                      "ptxas_decoder_conv": report["ptxas"]["decoder_conv"]}), flush=True)

    # -- 2. main path ---------------------------------------------------
    t0 = time.perf_counter()
    slide = synthetic_wsi(**SLIDE)
    cfg = default_config()
    tmp = Path(tempfile.mkdtemp(prefix="run_", dir=out_dir))
    ann = _annotations(slide, cfg.patch_size, N_TILES, tmp / "smoke_annotations_with_coords.csv")
    seed_model = HoverNeXt(HOVERNEXT_TINY)
    init_weights(seed_model, torch.Generator().manual_seed(0))
    fit_tiles = sample_tissue_tiles(slide, 16, HOVERNEXT_TINY.input_size, seed=1)
    sd = fit_heads(HOVERNEXT_TINY, seed_model.state_dict(), fit_tiles, dtype=torch.bfloat16,
                   device=dev)
    model = NucleiModel.build(HOVERNEXT_TINY, state_dict=sd, tta=cfg.hovernext.tta,
                              dtype=torch.bfloat16, device=dev,
                              max_instances=cfg.hovernext.max_instances_per_tile)
    report["setup_s"] = time.perf_counter() - t0

    # warm-up run (cuDNN plans, allocator), then the counted, timed run
    run_hovernet_pipeline_on_wsi_tiles(slide, ann, tmp, "warm", model, cfg)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    nuclei = run_hovernet_pipeline_on_wsi_tiles(slide, ann, tmp, "smoke", model, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    main_kernels = ("convnext_block", "cc_sizes", "flood", "instance_stats")
    n_batches = -(-N_TILES // cfg.hovernext.batch_size)
    report.update(main_path_s=dt, tiles=N_TILES, batches=n_batches,
                  tiles_per_s=N_TILES / dt, nuclei=len(nuclei), launches=launches,
                  cc_slot_overflow_tiles=nuclei.attrs.get("cc_slot_overflow_tiles"))
    print(f"main path: {N_TILES} tiles in {dt:.3f} s, {len(nuclei)} nuclei, "
          f"launches {launches}", flush=True)
    failures = [f"{n} never launched on the main path" for n in main_kernels
                if launches[n] <= 0]
    failures += [f"{n} launched on the default path" for n, k in launches.items()
                 if n not in main_kernels and k]
    failures += _table_failures(nuclei, cfg.patch_size, "main path")

    # -- 2b. the chain's embed and graph stages, after the nuclei stage ------
    roi = select_tiles_for_hovernet(load_tile_annotations(ann))[["x", "y"]].to_numpy(np.int64)
    report["chain"] = _chain(slide, roi, nuclei, tmp, wrappers, failures)
    chain_line = {k: report["chain"][k] for k in (
        "tiles", "min_cos_bf16_vs_f32", "f32_card_vs_cpu_excess", "mutant_no_pos_embed_min_cos",
        "forward_512_ms", "forward_512_bound_ms", "embed_tiles_per_s", "artifacts_written",
        "graph_nodes", "graph_knn_edges", "graph_radius_edges", "graph_build_s", "graph_stats_s",
        "device_radius_points", "device_radius_edges", "device_radius_equal_ckdtree",
        "device_radius_s")}
    print(json.dumps({"chain": chain_line}), flush=True)

    # one batch of the main path's own data, stage by stage
    coords = pd.read_csv(ann).query("in_tme_roi")[["x", "y"]].to_numpy()[:128].tolist()
    off = (HOVERNEXT_TINY.input_size - cfg.patch_size) // 2
    tiles = np.stack([
        np.pad(slide.read_region((x, y), 0, (cfg.patch_size,) * 2),
               ((off, off), (off, off), (0, 0)), mode="reflect") for x, y in coords])
    tiles_d = torch.from_numpy(tiles).to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.inference_mode():
        ev[0].record()
        pixels = tiles_d.float() / 255.0
        out = tta_forward(model.model, pixels, tta=4)
        np_prob = torch.softmax(out["np"], dim=-1)[..., 1]
        hv = out["hv"]
        ev[1].record()
        blb = np_prob > 0.5
        _, sizes, _, _ = cc_sizes_adaptive(blb)
        blb = blb & (sizes >= 10)
        ev[2].record()
        overall, dist = ws.hv_energy(hv[..., 0], hv[..., 1], blb)
        mmask = blb & (overall < 0.4)
        _, _, mdense, _ = cc_sizes_adaptive(mmask, min_size=3)
        markers = torch.where(mdense > 0, mdense, INF)
        ev[3].record()
        lbl = marker_watershed(dist, markers, blb)
        ev[4].record()
        li = torch.where(lbl < INF, lbl, 0)[:, off:-off, off:-off].contiguous()
        ti = out["tp"].argmax(-1).to(torch.int32)[:, off:-off, off:-off].contiguous()
        instance_features_batch(li, ti, max_instances=model.max_instances)
        ev[5].record()
    torch.cuda.synchronize()
    names = ["forward_tta4", "cc_sizes_fg", "energy_and_cc_sizes_markers", "flood", "crop_and_stats"]
    report["batch_breakdown_ms"] = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    # -- 3. kernels against their plain versions -------------------------
    kernels = []

    # K1 at the three encoder stage shapes (512 images = 128 tiles x TTA 4),
    # then at ragged shapes
    stacked = torch.cat([torch.rot90(pixels, k, dims=(1, 2)) for k in range(4)], dim=0)
    xs = _stage_inputs(model, stacked)
    del stacked
    depths = HOVERNEXT_TINY.encoder.depths
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "abs_err": 0.0,
          "per_stage": []}
    by_t = {"bytes": 0.0, "operations": 0.0}
    for s, x in enumerate(xs):
        wts = _check_weights(model.model.encoder.stages[s][0], seed=100 + s)
        st = _k1_check(f"stage {s}", x, wts, failures)
        st["parts"] = [_k1_parts_check(f"stage {s}", x, wts, exact, failures,
                                       see_unfused=s == 0) for exact in (True, False)]
        k1["abs_err"] = max(k1["abs_err"], st["max_abs_err_erf"], st["max_abs_err_tanh"])
        with torch.inference_mode():
            ms = _sync_time(lambda: convnext_block(x, *wts), reps=5)
            pms = _sync_time(lambda: convnext_block_plain(x, *wts), reps=1)
            lms = _sync_time(_k1_library(x, wts), reps=5)
        st["launches"] = _k1_launch_times(x, wts)
        b, h, w, c = x.shape
        px = b * h * w
        nbytes = 2 * px * c * 2 + sum(t.numel() * 2 for t in wts)
        bnd, by = _bound_ms(nbytes, [(px * 16 * c * c, PEAK_BF16), (px * c * 98, PEAK_F32)])
        st.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bnd, bound_by=by)
        k1["per_stage"].append(st)
        k1["ms"] += depths[s] * ms
        k1["plain_ms"] += depths[s] * pms
        k1["library_ms"] += depths[s] * lms
        k1["bound_ms"] += depths[s] * bnd
        by_t[by] += depths[s] * bnd
    del xs
    k1["ragged"] = []
    for j, (rb, rh, rw, c) in enumerate(K1_RAGGED):
        s = [sc for _, sc in K1_STAGES].index(c)
        wts = _check_weights(model.model.encoder.stages[s][0], seed=110 + j)
        x = torch.randn((rb, rh, rw, c), generator=torch.Generator().manual_seed(120 + j))
        x = x.to(dev, torch.bfloat16)
        k1["ragged"].append(_k1_check(f"{rb}x{rh}x{rw}x{c}", x, wts, failures))
        k1["ragged"][-1]["parts"] = [_k1_parts_check(f"{rb}x{rh}x{rw}x{c}", x, wts, exact,
                                                     failures) for exact in (True, False)]
    k1["ptxas"] = _k1_ptxas(cuda)
    print(json.dumps({"k1": {"per_stage": [{k: st[k] for k in ("shape", "ms", "library_ms",
                                                               "launches")}
                                           for st in k1["per_stage"]],
                             "ptxas": k1["ptxas"]}}), flush=True)
    kernels.append({
        "name": "convnext_block", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/convnext_block.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/convnext_block.py:174",
        "launches": launches["convnext_block"], "max_abs_err": k1["abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": max(by_t, key=by_t.get),
        "library_ms": k1["library_ms"],
        "note": "ms/plain_ms/bound_ms/library_ms: one batch's 15 block calls (3 at stage 0, 3 at "
                "1, 9 at 2), each call three launches (per_stage[].launches: ms, bytes, share of "
                "peak); bf16; vectors (biases, LN, GRN) drawn from a seed; tolerance, both GELU "
                f"modes: |kernel - plain| <= 2 bf16 ulp(|plain|) + {K1_ATOL} elementwise, also at "
                "the ragged shapes; library_ms: the block as a chain of PyTorch calls (cuDNN "
                "depthwise conv, layer_norm, cuBLAS linear, gelu, GRN as tensor ops, linear, "
                "residual add; bf16 channels-last), not one call, and never called by the port",
        "per_stage": k1["per_stage"], "ragged": k1["ragged"], "ptxas": k1["ptxas"],
    })

    # K2 on the foreground and marker masks of this batch, K3 on its energy,
    # markers and foreground; their inputs kept for --ab
    fg = np_prob > 0.5
    torch.save({"fg": fg.cpu(), "mmask": mmask.cpu(), "dist": dist.cpu(),
                "markers": markers.cpu(), "blb": blb.cpu()}, out_dir / "k23_inputs.pt")
    kernels.append(_check_k2(fg, mmask, launches, failures))
    kernels.append(_check_k3(dist, markers, blb, launches, failures))
    print(json.dumps({k["name"]: k["counts"] for k in kernels[-2:]}), flush=True)

    # K4 on this batch's cropped labels and types, kept for --ab
    torch.save({"li": li.cpu(), "ti": ti.cpu(), "slots": model.max_instances},
               out_dir / "k4_inputs.pt")
    kernels.append(_check_k4(li, ti, model.max_instances, launches, failures))
    print(json.dumps({"instance_stats": {k: kernels[-1][k] for k in (
        "ms", "device_ms", "geometry", "ms_other_cluster", "mutants_differ", "ptxas")}}), flush=True)

    report["tf32_scope"] = _tf32_scope_check(failures)
    print(json.dumps({"tf32_scope": report["tf32_scope"]}), flush=True)

    # -- 4. the slice's post-processing: kernels vs plain versions -------
    with torch.inference_mode():
        lk, _ = ws.hover_instances_batch(np_prob, hv)
        lp, _ = ws.hover_instances_batch(np_prob.cpu(), hv.cpu())
        diff = int((lk.cpu() != lp).sum())
        fk = instance_features_batch(li, ti, model.max_instances)
        fp = instance_features_batch(li.cpu(), ti.cpu(), model.max_instances)
        ferr = max(float((fk[k].cpu().float() - fp[k].float()).abs().max()) for k in fk)
    report["postproc_label_diff"] = diff
    report["features_max_abs_diff"] = ferr
    report["nuclei_per_tile"] = len(nuclei) / N_TILES
    if diff:
        failures.append(f"hover_instances_batch: {diff} labels differ between card and CPU")
    if ferr > 1e-3:
        failures.append(f"instance features differ between card and CPU by {ferr:.3g}")

    # -- 4b. the slide feed: a JPEG TIFF through the port's decoder ----------
    report["feed"] = _feed(slide, roi, ann, model, cfg, launches, tmp, wrappers, failures)
    feed_line = {k: report["feed"].get(k) for k in (
        "decoder_build_s", "decoder_link_line", "level0_tiles", "fancy_tiles_differing_from_pil",
        "planar_card_tiles_differing_from_nearest", "planar_card_equal_cpu",
        "mutant_cb_cr_swapped_tiles_differing", "cases", "decode_tiles_per_s", "bytes_per_tile",
        "h2d_ms_per_batch", "nuclei_tiles_per_s", "nuclei", "nuclei_routes",
        "nuclei_inputs_equal_host_nearest", "nuclei_rgb_feed_tiles_per_s",
        "embed_tiles_per_s", "embed_features_equal_rgb_nearest")}
    print(json.dumps({"feed": feed_line}), flush=True)

    # -- 4c. the sliding-window WSI mode and the CLI --------------------------------
    report["wsi"] = _wsi(slide, tmp / "smoke.svs", sd, model, cfg, report, tmp, wrappers,
                         failures)
    wsi_line = _wsi_line(report["wsi"])
    print(json.dumps({"wsi": wsi_line}), flush=True)

    # -- 5./6. the decoder configurations and their kernels -----------------
    del out, np_prob, hv, blb, overall, dist, mmask, mdense, markers, lbl, li, ti, lk, lp
    models, counts = _decoder_configs(slide, cfg, sd, tmp, pixels, model, wrappers, report,
                                      failures)
    config_launches = {n: counts[cname][n] for cname, (_, ks) in CONFIGS.items() for n in ks}
    kernels += _check_decoder_kernels(models, pixels, config_launches, failures)
    del models
    torch.cuda.empty_cache()

    # -- 7./8. the islands path, K5 and K6 -----------------------------------
    path_masks, island_launches = _islands(slide, tmp, wrappers, report, failures)
    kernels += _check_cc(path_masks, fg, island_launches, wrappers, failures, out_dir)

    shutil.rmtree(tmp, ignore_errors=True)
    report["kernels"] = kernels
    report["failures"] = failures
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"batch_breakdown_ms": report["batch_breakdown_ms"],
                      "postproc_label_diff": diff, "features_max_abs_diff": ferr,
                      "islands_s": {d: r["s"] for d, r in report["islands"]["runs"].items()}}))
    print(json.dumps({"chain": chain_line}))
    print(json.dumps({"feed": feed_line}))
    print(json.dumps({"wsi": wsi_line}))
    print(f"slice: {report['tiles_per_s']:.2f} tiles/s over {N_TILES} tiles "
          f"({n_batches} batches of {cfg.hovernext.batch_size})")
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys} for kk in kernels]}))
    print(report["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
