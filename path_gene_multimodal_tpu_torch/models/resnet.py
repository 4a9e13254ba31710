"""ResNet34 and the IDaRS molecular-predictor ensemble.

Counterpart of the JAX package's ``models/resnet.py``: the reference's
TIAToolbox ``PatchPredictor`` path (``molecular_feature_extraction.py:
110-139``) runs six ``resnet34-idars-*`` checkpoints (msi, hm, cin, cimp,
braf, tp53), each a ResNet34 with a 2-class head. ``ResNet``'s
``state_dict()`` has torchvision's names (``conv1``, ``bn1``,
``layerN.B.conv1/bn1/conv2/bn2``, ``layerN.B.downsample.0/1``, ``fc``),
which the JAX package's ``convert_resnet34`` reads and which TIAToolbox's
checkpoints carry.

Parameters and BatchNorm statistics stay f32; ``dtype`` is the compute
dtype, rounded where flax rounds:

- a conv casts its input and kernel to ``dtype`` and returns ``dtype``
  (cuDNN and oneDNN accumulate in f32);
- a BatchNorm takes the conv's ``dtype`` output and computes
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, rounding to
  ``dtype`` once (flax's ``_normalize``). It is not folded into the conv;
- the max pool pads with -inf, the residual add and ReLU run in ``dtype``;
- the global mean sums in f32 and returns ``dtype`` (``jnp.mean``); the
  head is a ``dtype`` product with the bias added in ``dtype``.

``IDaRSEnsemble`` holds one network a task and runs them one after the
other on the same batch of pixels (six cuDNN forwards a batch). The JAX
package stacks the six parameter trees and vmaps one forward over them;
grouped convolutions would be the stacked form here, and a loop is the
simpler one. With a ``mesh`` (``parallel/mesh.py``) the six networks are
copied to each of its devices and each batch is split over its shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from path_gene_multimodal_tpu_torch.models.clip import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    preprocess_tiles,
)
from path_gene_multimodal_tpu_torch.models.layers import dense, product_precision
from path_gene_multimodal_tpu_torch.parallel.mesh import Mesh, gather, replicate, run_sharded


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # ResNet34
    num_classes: int = 2
    width: int = 64


RESNET34_IDARS = ResNetConfig()


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=True)`` on a ``dtype`` input:
    the affine map in f32 in flax's order, one rounding to ``dtype``."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = torch.sub(x, bn.running_mean.view(-1, 1, 1))  # f32 (the statistics are)
    return y.mul_(mul.view(-1, 1, 1)).add_(bn.bias.view(-1, 1, 1)).to(dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.relu_(_bn(self.bn1, _conv(self.conv1, x, dtype), dtype))
        y = _bn(self.bn2, _conv(self.conv2, y, dtype), dtype)
        if self.downsample is not None:
            x = _bn(self.downsample[1], _conv(self.downsample[0], x, dtype), dtype)
        return torch.relu_(y + x)


class ResNet(nn.Module):
    """``forward`` takes (B, H, W, 3) normalized f32 pixels and returns the
    (B, num_classes) logits in ``dtype``."""

    def __init__(self, cfg: ResNetConfig = RESNET34_IDARS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(w, eps=1e-5)
        cin = w
        for s, blocks in enumerate(cfg.stage_sizes):
            cout = w * 2 ** s
            layer = []
            for b in range(blocks):
                layer.append(BasicBlock(cin, cout, 2 if (s > 0 and b == 0) else 1))
                cin = cout
            setattr(self, f"layer{s + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(cin, cfg.num_classes)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        with product_precision(dt):
            x = pixels.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
            x = torch.relu_(_bn(self.bn1, _conv(self.conv1, x, dt), dt))
            x = F.max_pool2d(x, 3, 2, 1)
            for s in range(len(self.cfg.stage_sizes)):
                for blk in getattr(self, f"layer{s + 1}"):
                    x = blk(x, dt)
            x = x.float().mean(dim=(2, 3)).to(dt)
            return dense(x, self.fc.weight, self.fc.bias, dt)


def init_weights(net: ResNet, gen: torch.Generator) -> None:
    """Seeded random weights, drawn on ``gen``'s device: convs N(0, 2 /
    fan_in) (He), BatchNorm scales N(1, 0.1) (the second of each block's
    halved, so that the residual sums stay near unit scale over 16 blocks),
    biases N(0, 0.1), running means N(0, 0.1) and variances U(0.5, 1.5),
    so that a check on the forward sees every one of them; the head N(0,
    1 / (16 fan_in)), which keeps the logits near unit scale and the
    probabilities off 0 and 1, its bias N(0, 0.1)."""
    dev = gen.device
    with torch.no_grad():
        for name, t in list(net.named_parameters()) + list(net.named_buffers()):
            if name.endswith("num_batches_tracked"):
                continue
            shape = t.shape
            if name.endswith("running_var"):
                v = torch.rand(shape, generator=gen, device=dev) + 0.5
            elif t.ndim == 4:
                v = torch.randn(shape, generator=gen, device=dev) * (2.0 / t[0].numel()) ** 0.5
            elif name == "fc.weight":
                v = torch.randn(shape, generator=gen, device=dev) * 0.25 * shape[1] ** -0.5
            elif name.endswith("weight"):  # a BatchNorm scale
                half = name.endswith(("bn2.weight", "downsample.1.weight"))
                v = (torch.randn(shape, generator=gen, device=dev) * 0.1 + 1.0) * (
                    0.5 if half else 1.0)
            else:  # biases and running means
                v = torch.randn(shape, generator=gen, device=dev) * 0.1
            t.copy_(v)


def seeded_resnet(cfg: ResNetConfig, seed: int, dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda") -> ResNet:
    """A ``ResNet`` on ``device`` with ``init_weights`` from a generator on
    that device seeded with ``seed`` (the same seed gives other weights on
    another device type)."""
    device = torch.device(device)
    with torch.device("meta"):
        net = ResNet(cfg, dtype)
    net = net.to_empty(device=device).eval()
    for m in net.modules():  # to_empty leaves the counter unset
        if isinstance(m, nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    init_weights(net, torch.Generator(device).manual_seed(seed))
    return net


class IDaRSEnsemble:
    """One ResNet a task, on one device. ``state_dicts`` (torchvision names,
    one a task, f32) or, if it is None, seeded random weights from ``seed +
    i`` for task i. Runs on the card unless the caller passes
    ``device="cpu"``; ``dtype`` is the compute dtype (bf16 by default, as
    the JAX package's). With a ``mesh``, the networks are built on its first
    device (``device``) and copied to each other one, and each batch is
    split over the shards (a last batch that does not divide the mesh
    unevenly: the first shards take a row more), the probabilities
    gathered in order on the first device."""

    def __init__(
        self,
        tasks: Sequence[str],
        state_dicts: Sequence[Mapping[str, torch.Tensor]] | None = None,
        cfg: ResNetConfig = RESNET34_IDARS,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ):
        self.tasks = list(tasks)
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else torch.device(device)
        if state_dicts is not None and len(state_dicts) != len(self.tasks):
            raise ValueError("one state dict per task required")
        self.models: list[ResNet] = []
        for i in range(len(self.tasks)):
            if state_dicts is None:
                net = seeded_resnet(cfg, seed + i, dtype, self.device)
            else:
                with torch.device("meta"):
                    net = ResNet(cfg, dtype)
                net = net.to_empty(device=self.device).eval()
                net.load_state_dict(state_dicts[i], strict=True)
            # the kernels in NHWC order, as the activations are laid out
            self.models.append(net.to(memory_format=torch.channels_last))
        self._replicas = None
        if mesh is not None:
            copies = replicate(nn.ModuleList(self.models), mesh)
            self._replicas = {d: list(nets) for d, nets in copies.items()}

    @torch.inference_mode()
    def __call__(self, tiles_u8) -> torch.Tensor:
        """uint8 (B, 224, 224, 3) (numpy or torch) → (num_tasks, B) f32
        P(class=1) on the device (reference :136), enqueued without waiting
        for it. The pixels are ``(u8 / 255 - mean) / std`` in f32 with the
        ImageNet statistics; the softmax is f32 over the logits."""
        tiles = tiles_u8 if torch.is_tensor(tiles_u8) else torch.from_numpy(np.asarray(tiles_u8))
        if self.device.type == "cuda" and tiles.device.type == "cpu":
            tiles = tiles.pin_memory()
        if self.mesh is None:
            return self._forward(self.models, tiles.to(self.device, non_blocking=True))
        outs = run_sharded(self.mesh, lambda dev, t: self._forward(self._replicas[dev], t), tiles)
        return gather(outs, self.device, dim=1)

    @staticmethod
    def _forward(models: list[nn.Module], tiles: torch.Tensor) -> torch.Tensor:
        pixels = preprocess_tiles(tiles, IMAGENET_MEAN, IMAGENET_STD)
        logits = torch.stack([net(pixels) for net in models])  # (T, B, classes)
        return torch.softmax(logits.float(), dim=-1)[..., 1]
