"""K1 (the ConvNeXtV2 block kernel) called repeatedly on one input: do its
GRN sums and its output keep their bits from call to call?

    python3 tools/k1_repeat_check.py [ROOT]

ROOT holds the ``path_gene_multimodal_tpu_torch`` package to test (default:
this checkout; e.g. an earlier commit unpacked with ``git archive`` under a
directory git ignores). Runs on the card: stage 0 of HoverNeXt-tiny (512 x
64 x 64 x 96, bf16) with weights drawn from a seed, 8 calls of the three
launches one by one (``launch_parts``) and 4 of the block; prints one JSON
line with the calls whose GRN sums or output differ from the first call's,
and the block's ms a call at the three encoder stage shapes (CUDA events
over 20 calls after 3) with ``ms_per_batch``, the 3 + 3 + 9 calls of one
batch of 128 tiles x TTA 4. To compare two copies, run them in one call
in turns (parent, this, this, parent).
"""

import json
import sys
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
sys.path.insert(0, str(root))

import torch  # noqa: E402

from path_gene_multimodal_tpu_torch.ops import convnext_block as k1  # noqa: E402
from path_gene_multimodal_tpu_torch.ops import cuda  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("k1_repeat_check: no CUDA device")
cuda.build_all(("convnext_block",))
g = torch.Generator().manual_seed(0)
b, h, w, c = 512, 64, 64, 96
x = torch.randn((b, h, w, c), generator=g).to("cuda", torch.bfloat16)


def r(*shape, scale=0.1):
    return (torch.randn(shape, generator=g) * scale).to("cuda", torch.bfloat16)


w1, w2 = r(4 * c, c).t(), r(c, 4 * c).t()  # transposes of contiguous tensors, as the kernel takes
wts = (r(7, 7, c), r(c), 1 + r(c), r(c), w1, r(4 * c), r(4 * c), r(4 * c), w2, r(c))
sums, outs = [], []
for _ in range(8):
    parts = k1.launch_parts(x, wts)
    for name in ("dw_ln", "pw1", "pw2"):
        parts[name]()
    torch.cuda.synchronize()
    sums.append(parts["buffers"][2].clone())
    outs.append(parts["buffers"][3].clone())
blocks = [k1.convnext_block(x, *wts) for _ in range(4)]


def ms_per_call(shape) -> float:
    xs = torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
    cs = shape[-1]
    ws = (r(7, 7, cs), r(cs), 1 + r(cs), r(cs), r(4 * cs, cs).t(), r(4 * cs), r(4 * cs),
          r(4 * cs), r(cs, 4 * cs).t(), r(cs))
    for _ in range(3):
        k1.convnext_block(xs, *ws)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        k1.convnext_block(xs, *ws)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


stages = {f"{b}x{s}x{s}x{cs}": ms_per_call((b, s, s, cs)) for s, cs in ((64, 96), (32, 192), (16, 384))}
times = list(stages.values())
print(json.dumps({
    "root": str(root), "device": torch.cuda.get_device_name(0),
    "gsum_calls_differing": sum(not torch.equal(t, sums[0]) for t in sums[1:]),
    "gsum_elements_differing_max": max(int((t != sums[0]).sum()) for t in sums),
    "out_calls_differing": sum(not torch.equal(t, outs[0]) for t in outs[1:]),
    "out_elements_differing_max": max(int((t != outs[0]).sum()) for t in outs),
    "block_calls_differing": sum(not torch.equal(t, blocks[0]) for t in blocks[1:]),
    "ms_per_call": stages, "ms_per_batch": 3 * times[0] + 3 * times[1] + 9 * times[2],
}))
