"""Which module of the canonical bf16 HoverNeXt (HoverNeXt-tiny as
``NucleiModel.build`` makes it: K1 blocks, the low-res final stage) gives an
image other bits when its batch is cut into smaller calls?

    python3 tools/hovernext_batch_split.py

Runs on the card: 256 images of 256² drawn from a seed (64 tiles x TTA 4)
through the model in one call, then in calls of 64 and of 32 images;
forward hooks record every module's output. Prints one JSON line a split:
the first module, in execution order, whose output differs from the
one-call run's, how many modules differ, and the differing elements of
each head.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY  # noqa: E402
from path_gene_multimodal_tpu_torch.ops import cuda  # noqa: E402
from path_gene_multimodal_tpu_torch.pipeline.nuclei import NucleiModel  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("hovernext_batch_split: no CUDA device")
cuda.build_all(("convnext_block",))
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
net = NucleiModel.build(HOVERNEXT_TINY, seed=0, dtype=torch.bfloat16, device="cuda").model
x = torch.rand((256, 256, 256, 3), generator=torch.Generator().manual_seed(3)).cuda()
order: list[str] = []
outs: dict[str, list] = {}


def hook(name):
    def record(module, inputs, out):
        if name not in outs:
            order.append(name)
        outs.setdefault(name, []).append(out)
    return record


for name, module in net.named_modules():
    if name:
        module.register_forward_hook(hook(name))
for split in (64, 32):
    outs.clear()
    order.clear()
    with torch.inference_mode():
        full = net(x)
        parts = [net(x[i : i + split]) for i in range(0, len(x), split)]
    differing = [n for n in order if torch.is_tensor(outs[n][0]) and outs[n][0].shape[0] == len(x)
                 and not torch.equal(outs[n][0], torch.cat(outs[n][1:]))]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "images": len(x), "split": split,
        "first_module_differing": differing[0] if differing else None,
        "its_type": type(net.get_submodule(differing[0])).__name__ if differing else None,
        "modules_differing": len(differing),
        "head_elements_differing": {k: int((full[k] != torch.cat([p[k] for p in parts])).sum())
                                    for k in full},
        "cudnn": torch.backends.cudnn.version()}))
