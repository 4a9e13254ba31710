"""ConvNeXtV2 state-dict shapes → ``ConvNeXtConfig``.

A copy of ``infer_convnext_config`` from the JAX package's
``models/weights_convnext.py``, for the official-FCMAE naming that
HoverNeXt's ``pannuke_convnextv2_tiny_3`` encoder uses
(``downsample_layers.S.*``, ``stages.S.B.{dwconv,norm,pwconv1,grn,pwconv2}``).
The port's ``models.convnext.ConvNeXtV2`` already takes these key names as
its own ``state_dict()``, so no conversion is needed beyond the shapes.
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
            if any(k.startswith(f"stages.{s}.blocks.") for k in sd):
                raise NotImplementedError(
                    "timm 'stages.S.blocks.B.conv_dw' naming (the published hover_next "
                    "layout) is not ported yet: ROADMAP Queue 1 item 16"
                )
            break
        depths.append(b)
        dims.append(int(np.shape(sd[f"stages.{s}.0.dwconv.weight"])[0]))
        s += 1
    if not depths:
        raise ValueError("no ConvNeXt stages found in state_dict")
    return ConvNeXtConfig(depths=tuple(depths), dims=tuple(dims))
