"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out DIR]

1. builds the four kernels of the nuclei stage from
   ``path_gene_multimodal_tpu_torch/csrc`` with nvcc (one process per
   source, in parallel) into ``build/kernels/``;
2. drives the nuclei stage the way a user would: ``synthetic_wsi`` →
   ``fit_heads`` on HoverNeXt-tiny → ``NucleiModel.build(HOVERNEXT_TINY,
   tta=4, dtype=bfloat16, device="cuda")`` →
   ``run_hovernet_pipeline_on_wsi_tiles`` over full batches of 128 tiles,
   with every kernel's launch count set to 0 just before and read just
   after;
3. holds each kernel against its plain PyTorch version on the card, on the
   main path's own inputs at its shapes (K1 with its bias, LN and GRN
   vectors drawn from a seed, in both GELU modes; K2 also at slot budgets
   under which the gated re-run fires and tiles overflow), and times
   kernel, plain version and (where one exists) one PyTorch library call
   computing the same function;
4. checks the slice's output (the kernels' post-processing against the
   plain versions on the same maps; a non-empty, finite nuclei table).

Prints the kernels' JSON line, the slice's tiles/s and the card's name and
power limit, then, as the last line, ``{"ok": true, "device": {...}}``.
Any failure exits non-zero. Details go to ``DIR/chip_smoke.json`` (default
``build/chip_smoke/``, which git ignores).
"""

from __future__ import annotations

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


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _annotations(slide, tile: int, n: int, path: Path) -> Path:
    """The TME-ROI tiles: a tile grid over the slide, in the ROI where at
    least half the tile is tissue (non-background)."""
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


def _k1_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / (2 bf16 ulp(|ref|) + K1_ATOL), elementwise; the
    check passes at <= 1."""
    tol = 2 * _bf16_ulp(ref) + K1_ATOL
    return float(((got.float() - ref.float()).abs() / tol).max())


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="directory for chip_smoke.json and scratch files")
    out_dir = ap.parse_args(argv).out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import pandas as pd

    from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY, default_config
    from path_gene_multimodal_tpu_torch.io.slide import synthetic_wsi
    from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt, init_weights, tta_forward
    from path_gene_multimodal_tpu_torch.ops import cuda
    from path_gene_multimodal_tpu_torch.ops import watershed as ws
    from path_gene_multimodal_tpu_torch.ops.cc_sizes import (
        cc_sizes, cc_sizes_adaptive, cc_sizes_adaptive_plain, cc_sizes_plain,
    )
    from path_gene_multimodal_tpu_torch.ops.components import INF
    from path_gene_multimodal_tpu_torch.ops.convnext_block import (
        convnext_block, convnext_block_plain,
    )
    from path_gene_multimodal_tpu_torch.ops.flood import marker_watershed, marker_watershed_plain
    from path_gene_multimodal_tpu_torch.ops.instance_stats import (
        instance_stats, instance_stats_plain,
    )
    from path_gene_multimodal_tpu_torch.ops.instances import instance_features_batch
    from path_gene_multimodal_tpu_torch.pipeline.nuclei import (
        NucleiModel, run_hovernet_pipeline_on_wsi_tiles,
    )
    from path_gene_multimodal_tpu_torch.utils.headfit import fit_heads, sample_tissue_tiles

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir.mkdir(parents=True, exist_ok=True)
    report: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": torch.cuda.get_device_name(0), "smi": _smi()}
    dev = torch.device("cuda")
    wrappers = {"convnext_block": convnext_block, "cc_sizes": cc_sizes,
                "flood": marker_watershed, "instance_stats": instance_stats}

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    cuda.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {n: [ln.strip() for ln in cuda.build_log(n).splitlines()
                           if "registers" in ln or "bytes stack" in ln]
                       for n in cuda.KERNELS}
    print(f"built {len(cuda.KERNELS)} kernels in {report['build_s']:.1f} s", flush=True)

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
    n_batches = -(-N_TILES // cfg.hovernext.batch_size)
    report.update(main_path_s=dt, tiles=N_TILES, batches=n_batches,
                  tiles_per_s=N_TILES / dt, nuclei=len(nuclei), launches=launches,
                  cc_slot_overflow_tiles=nuclei.attrs.get("cc_slot_overflow_tiles"))
    print(f"main path: {N_TILES} tiles in {dt:.3f} s, {len(nuclei)} nuclei, "
          f"launches {launches}", flush=True)
    failures = [f"{n} never launched on the main path" for n, k in launches.items() if k <= 0]
    if len(nuclei) == 0:
        failures.append("empty nuclei table")
    num = nuclei[["centroid_x", "centroid_y", "area", "eccentricity", "major_axis_length"]]
    if not np.isfinite(num.to_numpy(np.float64)).all():
        failures.append("non-finite values in the nuclei table")
    if not ((nuclei["centroid_x"].between(0, cfg.patch_size))
            & (nuclei["centroid_y"].between(0, cfg.patch_size)) & (nuclei["area"] > 0)).all():
        failures.append("nuclei outside their tile or of zero area")

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
    npix = blb.numel()

    # K1 at the three encoder stage shapes (512 images = 128 tiles x TTA 4)
    stacked = torch.cat([torch.rot90(pixels, k, dims=(1, 2)) for k in range(4)], dim=0)
    xs = _stage_inputs(model, stacked)
    del stacked
    depths = HOVERNEXT_TINY.encoder.depths
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "abs_err": 0.0, "per_stage": []}
    by_t = {"bytes": 0.0, "operations": 0.0}
    for s, x in enumerate(xs):
        wts = _check_weights(model.model.encoder.stages[s][0], seed=100 + s)
        st = {"shape": list(x.shape)}
        with torch.inference_mode():
            for exact in (True, False):  # tanh last: its output is the mutants' reference
                got = convnext_block(x, *wts, exact_gelu=exact)
                ref = convnext_block_plain(x, *wts, exact_gelu=exact)
                mode = "erf" if exact else "tanh"
                st[f"max_abs_err_{mode}"] = float((got.float() - ref.float()).abs().max())
                st[f"excess_{mode}"] = _k1_excess(got, ref)
                k1["abs_err"] = max(k1["abs_err"], st[f"max_abs_err_{mode}"])
                if st[f"excess_{mode}"] > 1.0:
                    failures.append(f"K1 stage {s} ({mode} GELU): |kernel - plain| exceeds "
                                    f"2 ulp + {K1_ATOL} by x{st[f'excess_{mode}']:.3g}")
                del got
            # the check must see a wrong GRN and a dropped pw2 bias
            for what, i, v in (("grn_gamma=0", 6, 0.0), ("no_b2", 9, 0.0)):
                bad = list(wts)
                bad[i] = torch.full_like(wts[i], v)
                st[f"excess_if_{what}"] = _k1_excess(convnext_block_plain(x, *bad), ref)
                if st[f"excess_if_{what}"] <= 1.0:
                    failures.append(f"K1 stage {s}: the check does not see {what}")
            del ref
            ms = _sync_time(lambda: convnext_block(x, *wts), reps=5)
            pms = _sync_time(lambda: convnext_block_plain(x, *wts), reps=1)
        b, h, w, c = x.shape
        px = b * h * w
        nbytes = 2 * px * c * 2 + sum(t.numel() * 2 for t in wts)
        bnd, by = _bound_ms(nbytes, [(px * 16 * c * c, PEAK_BF16), (px * c * 98, PEAK_F32)])
        st.update(ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by)
        k1["per_stage"].append(st)
        k1["ms"] += depths[s] * ms
        k1["plain_ms"] += depths[s] * pms
        k1["bound_ms"] += depths[s] * bnd
        by_t[by] += depths[s] * bnd
    del xs
    kernels.append({
        "name": "convnext_block", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/convnext_block.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/convnext_block.py:174",
        "launches": launches["convnext_block"], "max_abs_err": k1["abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": max(by_t, key=by_t.get),
        "library_ms": None,
        "note": "ms/plain_ms/bound_ms: one batch's 15 block calls (3 at stage 0, 3 at 1, 9 at 2);"
                " bf16; vectors (biases, LN, GRN) drawn from a seed; tolerance, both GELU modes:"
                f" |kernel - plain| <= 2 bf16 ulp(|plain|) + {K1_ATOL} elementwise",
        "per_stage": k1["per_stage"],
    })

    # K2 on the foreground and marker masks of this batch
    with torch.inference_mode():
        fg = np_prob > 0.5
        worst = 0
        # the default budgets (512/4096) and budgets around this batch's
        # median root count, under which the gated launch runs and some
        # tiles overflow
        big = int(cc_sizes_plain(fg)[3].median())
        k2_budgets = {"default": (512, 4096), "median": (max(1, big // 4), big)}
        k2_overflow = {}
        for m, ms_ in ((fg, 0), (mmask, 3)):
            for key, (small_, big_) in k2_budgets.items():
                a = cc_sizes_adaptive(m, min_size=ms_, small=small_, big=big_)
                p = cc_sizes_adaptive_plain(m, min_size=ms_, small=small_, big=big_)
                for t_a, t_p in zip(a, p):
                    worst = max(worst, int((t_a.long() != t_p.long()).sum()))
                k2_overflow[f"{key}_min{ms_}"] = int(p[3].sum())
        if not 0 < k2_overflow["median_min0"] < len(fg):
            failures.append(f"K2: median budgets {k2_budgets['median']} left the overflow flags "
                            f"all equal ({k2_overflow})")
        ms = _sync_time(lambda: cc_sizes_adaptive(fg), reps=10)
        pms = _sync_time(lambda: cc_sizes_adaptive_plain(fg), reps=1)
    if worst:
        failures.append(f"K2: {worst} values differ from the plain version")
    bnd, by = _bound_ms(npix * 13, [(npix * 4, PEAK_F32)])
    kernels.append({
        "name": "cc_sizes", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/cc_sizes.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/cc_sizes.py:174",
        "launches": launches["cc_sizes"], "max_abs_err": float(worst),
        "ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "note": "one cc_sizes_adaptive call (512-slot launch + gated 4096-slot launch) on "
                "(128,256,256) foreground; 2 calls per batch; also checked at budgets "
                f"{k2_budgets['median']}, overflow tiles {k2_overflow}",
    })

    # K3 on this batch's energy, markers and foreground
    with torch.inference_mode():
        a = marker_watershed(dist, markers, blb)
        p = marker_watershed_plain(dist, markers, blb)
        worst = int((a != p).sum())
        ms = _sync_time(lambda: marker_watershed(dist, markers, blb), reps=5)
        pms = _sync_time(lambda: marker_watershed_plain(dist, markers, blb), reps=1)
    if worst:
        failures.append(f"K3: {worst} labels differ from the plain version")
    bnd, by = _bound_ms(npix * 13, [(128 * npix * 9, PEAK_F32)])
    kernels.append({
        "name": "flood", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/flood.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/flood.py:131",
        "launches": launches["flood"], "max_abs_err": float(worst),
        "ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "note": "(128,256,256); operations bound: 64 levels x 2 phases x 1 step x 9 "
                "neighbour reads per pixel at the f32 scalar rate",
    })

    # K4 on this batch's cropped labels and types
    with torch.inference_mode():
        sa, ma = instance_stats(li, ti, model.max_instances)
        sp, mp = instance_stats_plain(li, ti, model.max_instances)
        err = max(float((sa - sp).abs().max()), float((ma - mp).abs().max()))
        ms = _sync_time(lambda: instance_stats(li, ti, model.max_instances), reps=20)
        pms = _sync_time(lambda: instance_stats_plain(li, ti, model.max_instances), reps=2)
        bsz, h, w = li.shape
        idx = (li.long() + torch.arange(bsz, device=dev)[:, None, None] * model.max_instances).reshape(-1)
        pix = torch.arange(h * w, device=dev)
        x_, y_ = (pix % w).float().repeat(bsz), (pix // w).float().repeat(bsz)
        dx_, dy_ = x_ - w / 2, y_ - h / 2
        tpf = ti.reshape(-1)
        vals = torch.stack([torch.ones_like(x_), x_, y_, dx_ * dx_, dy_ * dy_, dx_ * dy_]
                           + [(tpf == t).float() for t in range(1, 6)], dim=1)
        acc = torch.zeros((bsz * model.max_instances, vals.shape[1]), device=dev)
        lms = _sync_time(lambda: acc.index_add_(0, idx, vals), reps=20)
    if err != 0.0:
        failures.append(f"K4: max |kernel - plain| = {err:.3g} (both sum exact integers)")
    nbytes = li.numel() * 8 + sa.numel() * 4 + ma.numel() * 4
    bnd, by = _bound_ms(nbytes, [(li.numel() * 12, PEAK_F32)])
    kernels.append({
        "name": "instance_stats", "route": "cuda",
        "source": "path_gene_multimodal_tpu_torch/csrc/instance_stats.cu",
        "replaces": "path_gene_multimodal_tpu/ops/pallas/instance_stats.py:123",
        "launches": launches["instance_stats"], "max_abs_err": err,
        "ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by, "library_ms": lms,
        "note": "(128,224,224) int32, S=512; library_ms: index_add_ of the (pixels, 11) "
                "value matrix (sums only, no bbox extrema)",
    })

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

    shutil.rmtree(tmp, ignore_errors=True)
    report["kernels"] = kernels
    report["failures"] = failures
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"batch_breakdown_ms": report["batch_breakdown_ms"],
                      "postproc_label_diff": diff, "features_max_abs_diff": ferr}))
    print(f"slice: {report['tiles_per_s']:.2f} tiles/s over {N_TILES} tiles "
          f"({n_batches} batches of {cfg.hovernext.batch_size})")
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in kk.items() if k not in ("note", "per_stage")}
                                  for kk in kernels]}))
    print(report["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
