"""ResNet34 weights between the JAX package's flax variables and the
port's torchvision-named ``state_dict``.

``resnet_state_dict_from_jax`` is the inverse of the JAX package's
``convert_resnet34`` (``models/weights_resnet.py``): it takes the flax
variables as numpy arrays (``{"params": ..., "batch_stats": ...}``) and
returns ``models.resnet.ResNet``'s ``state_dict``: conv kernels (kh, kw,
cin, cout) → (cout, cin, kh, kw), BatchNorm ``scale`` → ``weight`` and
the statistics → ``running_mean`` / ``running_var`` (with a zero
``num_batches_tracked``), the head (in, out) → (out, in). The JAX
converter reads these torchvision names (the TIAToolbox
``resnet34-idars-*`` layout) and gives the flax variables back exactly
(``tests/test_torch_resnet.py``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.models.resnet import RESNET34_IDARS, ResNetConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _names(cfg: ResNetConfig):
    """(flax module name, torchvision prefix) of every conv and BatchNorm,
    and whether each block has a projection shortcut."""
    yield "stem_conv", "conv1", "stem_bn", "bn1"
    cin = cfg.width
    for s, blocks in enumerate(cfg.stage_sizes):
        cout = cfg.width * 2 ** s
        for b in range(blocks):
            t, name = f"layer{s + 1}.{b}", f"stage{s}_block{b}"
            yield f"{name}/conv1", f"{t}.conv1", f"{name}/bn1", f"{t}.bn1"
            yield f"{name}/conv2", f"{t}.conv2", f"{name}/bn2", f"{t}.bn2"
            if cin != cout or (s > 0 and b == 0):
                yield f"{name}/down_conv", f"{t}.downsample.0", f"{name}/down_bn", f"{t}.downsample.1"
            cin = cout


def _get(tree: Mapping, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def infer_resnet_config(variables: Mapping) -> ResNetConfig:
    """The ``ResNetConfig`` of flax ``ResNet`` variables, from their names
    and shapes (the JAX package's artifacts of kind resnet34 store none)."""
    p = variables["params"]
    stages: dict[int, int] = {}
    for name in p:
        if name.startswith("stage"):
            s, b = name[len("stage"):].split("_block")
            stages[int(s)] = max(stages.get(int(s), 0), int(b) + 1)
    return ResNetConfig(stage_sizes=tuple(stages[s] for s in sorted(stages)),
                        num_classes=int(np.shape(p["fc"]["kernel"])[1]),
                        width=int(np.shape(p["stem_conv"]["kernel"])[3]))


def resnet_state_dict_from_jax(variables: Mapping, cfg: ResNetConfig = RESNET34_IDARS
                               ) -> dict[str, torch.Tensor]:
    """flax ``ResNet`` variables (numpy leaves) → the port's state dict."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    for conv, tconv, bn, tbn in _names(cfg):
        sd[f"{tconv}.weight"] = _t(np.transpose(np.asarray(_get(p, conv)["kernel"]), (3, 2, 0, 1)))
        sd[f"{tbn}.weight"] = _t(_get(p, bn)["scale"])
        sd[f"{tbn}.bias"] = _t(_get(p, bn)["bias"])
        sd[f"{tbn}.running_mean"] = _t(_get(st, bn)["mean"])
        sd[f"{tbn}.running_var"] = _t(_get(st, bn)["var"])
        sd[f"{tbn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    sd["fc.weight"] = _t(np.asarray(p["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(p["fc"]["bias"])
    return sd


def strip_prefixes(sd: Mapping) -> dict:
    """The JAX converter's tolerance of ``model.`` / ``module.`` wrappers."""
    sd = dict(sd)
    for prefix in ("model.", "module."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    return sd
