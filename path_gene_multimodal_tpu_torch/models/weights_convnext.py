"""ConvNeXtV2 state-dict shapes → ``ConvNeXtConfig``.

Copies of the JAX package's ``infer_convnext_config`` (the official FCMAE
naming: ``downsample_layers.S.*``, ``stages.S.B.{dwconv,norm,pwconv1,grn,
pwconv2}``, which the port's ``models.convnext.ConvNeXtV2`` takes as its
own ``state_dict()``) and ``infer_convnext_config_timm`` (timm's naming,
``stages.S.blocks.B.conv_dw``, the published hover_next encoder's, which
``models.convnext.TimmConvNeXtV2`` takes). ``infer_convnext_config`` routes
a timm-named state dict to the latter, as the JAX package's
``load_convnext_encoder_from_torch`` does.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig


def infer_convnext_config(sd: Mapping[str, np.ndarray]) -> ConvNeXtConfig:
    """Depths and dims from the ``stages.S.B.dwconv.weight`` keys."""
    dims = []
    depths = []
    s = 0
    while any(k.startswith(f"stages.{s}.") for k in sd):
        b = 0
        while f"stages.{s}.{b}.dwconv.weight" in sd:
            b += 1
        if b == 0:
            if s == 0 and any(k.startswith("stages.0.blocks.") for k in sd):
                return infer_convnext_config_timm(sd)
            break
        depths.append(b)
        dims.append(int(np.shape(sd[f"stages.{s}.0.dwconv.weight"])[0]))
        s += 1
    if not depths:
        raise ValueError("no ConvNeXt stages found in state_dict")
    return ConvNeXtConfig(depths=tuple(depths), dims=tuple(dims))


def infer_convnext_config_timm(sd: Mapping[str, np.ndarray]) -> ConvNeXtConfig:
    """Depths and dims from timm's ``stages.S.blocks.B.conv_dw.weight`` keys."""
    dims, depths = [], []
    s = 0
    while f"stages.{s}.blocks.0.conv_dw.weight" in sd:
        b = 0
        while f"stages.{s}.blocks.{b}.conv_dw.weight" in sd:
            b += 1
        depths.append(b)
        dims.append(int(np.shape(sd[f"stages.{s}.blocks.0.conv_dw.weight"])[0]))
        s += 1
    if not depths:
        raise ValueError("no timm ConvNeXt stages found in state_dict")
    return ConvNeXtConfig(depths=tuple(depths), dims=tuple(dims))
