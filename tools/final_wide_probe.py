"""K8-K11's wide kernel (``csrc/final_heads_wide.cu``) on the card: checks,
ptxas lines and times of each route at the final stage's widths.

    python3 tools/final_wide_probe.py [OUT_JSON]

Builds ``final_heads_wide`` and ``decoder_conv`` from this checkout, prints
the wide kernel's ptxas lines (registers, spills, advisories such as
C7519), holds K8 and K9 on the wide route (N chunks of 64 and of 128
columns) and K10/K11 on it against their plain versions in both GELU modes
(2 bf16 ulp + ``chip_smoke.DEC_ATOL``; heads ``chip_smoke._head_atol``),
and times, with CUDA events, each K8/K9 shape on the wide route at both
chunk widths, on K7's any route (``ops/decoder.py::_conv_any``) and
cuDNN's conv alone, beside the bound (``chip_smoke._bound_ms``): path
(4)'s model (b) batch (512 images, C = 40, 4 calls of 128) and the
sweep's 8-image shapes, and the wider widths at a final stage's full size;
K10 and K11 per batch at model (b)'s shapes. JSON lines as it goes, all of
it in OUT_JSON (default ``build/final_wide_probe.json``).
"""

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from path_gene_multimodal_tpu_torch.ops import cuda  # noqa: E402
from path_gene_multimodal_tpu_torch.ops import decoder as dec  # noqa: E402

# (kernel, B, H, W of x, cin, cout): the sweep's rows (K9 at half
# resolution), ragged tiles, cin != cout, cin 20 (no TMA), cout % 8 != 0
CHECKS = [("k9", 8, 32, 32, 40, 40), ("k9", 8, 32, 32, 256, 256), ("k9", 2, 16, 16, 1152, 1152),
          ("k9", 3, 17, 35, 40, 40), ("k9", 2, 6, 10, 20, 72), ("k9", 2, 8, 8, 96, 136),
          ("k9", 2, 6, 10, 40, 36), ("k8", 8, 64, 64, 40, 40), ("k8", 8, 64, 64, 256, 256),
          ("k8", 2, 32, 32, 1152, 1152), ("k8", 3, 32, 70, 40, 40), ("k8", 2, 32, 10, 20, 72),
          ("k8", 2, 32, 32, 96, 136), ("k8", 2, 32, 24, 40, 20)]
# (kernel, B, H, W of x, cin, cout): timed on each route
TIMES = [("k9", 8, 32, 32, c, c) for c in (40, 96, 128, 256, 1152)] + [
    ("k8", 8, 64, 64, c, c) for c in (40, 96, 128, 256, 1152)]
MODEL_B = {"k9": (512, 128, 128, 40, 40), "k8": (512, 256, 256, 40, 40)}
# (kernel, B, H, W of x, cin, cout): the wider widths at a final stage's
# full size (calls of 128 images; 16 at C = 1152)
TIMES_FULL = [("k9", 128, 128, 128, c, c) for c in (96, 128, 256)] + [
    ("k9", 16, 128, 128, 1152, 1152)] + [("k8", 128, 256, 256, c, c) for c in (96, 128, 256)] + [
    ("k8", 16, 256, 256, 1152, 1152)]


def rnd(gen, shape, std=1.0):
    return (std * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)


def geos(kernel, b, h, w, cin, cout):
    """(wide geometry at N chunks of 64, of 128, any-route geometry)."""
    if kernel == "k9":
        t = dec.UpsampleTiling(b, h, w, n_sm=cuda.sm_count(torch.device("cuda")), cin=cin,
                               cout=cout)
    else:
        t = dec.StripTiling(b, h, w, n_sm=cuda.sm_count(torch.device("cuda")), cin=cin,
                            cout=cout)
    g = t.head_geo
    return dataclasses.replace(g, n_max=64), dataclasses.replace(g, n_max=128), t.any_geo


def plain(kernel):
    return dec.upsample_final_plain if kernel == "k9" else dec.final_conv_gelu_plain


def check(kernel, b, h, w, cin, cout, seed) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, wt, bias = rnd(gen, (b, h, w, cin)), rnd(gen, (3, 3, cin, cout), (9 * cin) ** -0.5), rnd(
        gen, cout, 0.1)
    rec = {"shape": [kernel, b, h, w, cin, cout]}
    for name, g in zip(("wide64", "wide128"), geos(kernel, b, h, w, cin, cout)[:2]):
        for exact in (False, True):
            got = dec._conv_wide(g, x, wt, bias, exact)
            ref = plain(kernel)(x, wt, bias, exact)
            rec[f"{name}_excess_{'erf' if exact else 'tanh'}"] = cs._excess(got, ref, cs.DEC_ATOL)
    return rec


def check_heads(seed) -> list[dict]:
    """K10 and K11 (stated block-diagonal, and a full head) on the wide route."""
    out = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for (b, h, w, cin, c, n) in ((3, 18, 35, 40, 40, 17), (2, 8, 8, 96, 96, 33),
                                 (2, 6, 10, 20, 72, 10)):
        x, wt, bias = rnd(gen, (b, h, w, cin)), rnd(gen, (3, 3, cin, c), (9 * cin) ** -0.5), rnd(
            gen, c, 0.1)
        wh, bh = rnd(gen, (c, n), 0.3), rnd(gen, n, 0.1)
        wc, b4 = rnd(gen, (3, 3, cin, 4 * c), (9 * cin) ** -0.5), rnd(gen, 4 * c, 0.1)
        whb = torch.block_diag(*[rnd(gen, (c, n), 0.3) for _ in range(4)]).contiguous()
        bh4 = rnd(gen, 4 * n, 0.1)
        for exact in (False, True):
            mode = "erf" if exact else "tanh"
            got = dec.final_heads(x, wt, bias, wh, bh, exact_gelu=exact)
            ref = dec.final_heads_plain(x, wt, bias, wh, bh, exact)
            out.append({"k10": [b, h, w, cin, c, n], "mode": mode, "excess": cs._excess(
                got, ref, cs._head_atol(dec.upsample_final_plain(x, wt, bias, exact), wh))})
            got = dec.composite_final_heads(x, wc, b4, whb, bh4, exact_gelu=exact,
                                            block_diagonal=True)
            ref = dec.composite_final_heads_plain(x, wc, b4, whb, bh4, exact)
            out.append({"k11": [b, h, w, cin, c, n], "mode": mode, "excess": cs._excess(
                got, ref, cs._head_atol(dec.final_conv_gelu_plain(x, wc, b4, exact), whb))})
    return out


def times(kernel, b, h, w, cin, cout, seed, reps=3) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, wt, bias = rnd(gen, (b, h, w, cin)), rnd(gen, (3, 3, cin, cout), (9 * cin) ** -0.5), rnd(
        gen, cout, 0.1)
    chunks = x.split(cs.CHUNK)
    g64, g128, gany = geos(kernel, min(b, cs.CHUNK), h, w, cin, cout)
    rec = {"shape": [kernel, b, h, w, cin, cout], "calls": len(chunks)}
    runs = {"wide64": lambda c: dec._conv_wide(g64, c, wt, bias, False),
            "wide128": lambda c: dec._conv_wide(g128, c, wt, bias, False),
            "any": lambda c: dec._conv_any(gany, c, None, wt, bias)}
    for name, fn in runs.items():
        cs._idle(rec, name, 1.0)
        rec[f"{name}_ms"] = cs._sync_time(lambda: [fn(c) for c in chunks], reps=reps)
    xin = dec.upsample2x_bilinear(chunks[0]) if kernel == "k9" else chunks[0]
    lib = cs._conv_library(xin, wt)
    rec["library_ms"] = cs._sync_time(lambda: [lib() for _ in chunks], reps=reps)
    oh, ow = (2 * h, 2 * w) if kernel == "k9" else (h, w)
    px = b * oh * ow
    rec["bound_ms"], rec["bound_by"] = cs._bound_ms(
        2 * (b * h * w * cin + px * cout) + 2 * wt.numel(),
        [(2 * px * 9 * cin * cout, cs.PEAK_BF16), (16 * px * cout, cs.PEAK_F32)])
    del x, xin, chunks
    torch.cuda.empty_cache()
    return rec


def heads_times(seed) -> dict:
    """K10 and K11 (stated block-diagonal) per batch at model (b)'s shapes
    (512 x 128^2 x 40, 17 head columns, 4 calls), as chip_smoke.py's --ab
    times them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xb = rnd(gen, (512, 128, 128, 40))
    wb, bb = rnd(gen, (3, 3, 40, 40), (9 * 40) ** -0.5), rnd(gen, 40, 0.1)
    whb, bhb = rnd(gen, (40, 17), 0.3), rnd(gen, 17, 0.1)
    wcb, b4b = rnd(gen, (3, 3, 40, 160), (9 * 40) ** -0.5), rnd(gen, 160, 0.1)
    whd = torch.block_diag(*[rnd(gen, (40, 17), 0.3) for _ in range(4)]).contiguous()
    bh4b = rnd(gen, 68, 0.1)
    rec: dict = {}
    cs._idle(rec, "k10")
    rec["k10_batch_ms"] = cs._sync_time(
        lambda: [dec.final_heads(c, wb, bb, whb, bhb) for c in xb.split(cs.CHUNK)], reps=2)
    cs._idle(rec, "k11")
    rec["k11_batch_ms"] = cs._sync_time(
        lambda: [dec.composite_final_heads(c, wcb, b4b, whd, bh4b, block_diagonal=True)
                 for c in xb.split(cs.CHUNK)], reps=2)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("final_wide_probe: no CUDA device", file=sys.stderr)
        return 1
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build" / "final_wide_probe.json"
    torch.backends.cudnn.allow_tf32 = False
    cuda.build_all(("final_heads_wide", "decoder_conv"))
    log = cuda.build_log("final_heads_wide")
    short = lambda k: k[k.index("heads_wide_kernel"):][:40]  # noqa: E731
    res = {"smi": cs._smi(),
           "ptxas": {short(k): v for k, v in cs._ptxas_entries(log).items()},
           "advisories": {f"{k[:5]} {short(k)}": n for k, n in cs._ptxas_advisories(log).items()},
           "checks": [], "heads": [], "times": []}
    print(json.dumps({"ptxas": res["ptxas"], "advisories": res["advisories"]}), flush=True)
    with torch.inference_mode():
        for j, shape in enumerate(CHECKS):
            res["checks"].append(check(*shape, seed=50 + j))
            print(json.dumps(res["checks"][-1]), flush=True)
        res["heads"] = check_heads(80)
        print(json.dumps(res["heads"]), flush=True)
        for kernel, shape in MODEL_B.items():
            res["times"].append(times(kernel, *shape, seed=90, reps=2))
            print(json.dumps(res["times"][-1]), flush=True)
        for j, shape in enumerate(TIMES + TIMES_FULL):
            res["times"].append(times(*shape, seed=100 + j, reps=3 if shape[1] <= 16 else 2))
            print(json.dumps(res["times"][-1]), flush=True)
        res["heads_times"] = heads_times(120)
        print(json.dumps(res["heads_times"]), flush=True)
    worst = max(v for r in res["checks"] for k, v in r.items() if "excess" in k)
    worst = max([worst] + [r["excess"] for r in res["heads"]])
    res["worst_excess"] = worst
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps({"worst_excess": worst, "smi": res["smi"]}))
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
