"""ConvNeXtV2 state dicts → ``ConvNeXtConfig`` and the JAX package's
flax-layout encoder parameters.

``convert_convnextv2`` is a copy of the JAX package's (the FCMAE naming →
``{"params": encoder tree}`` and the unconsumed keys); its tree is what
``cli/convert_weights`` writes for kind ``convnext``, and
``models.weights_hovernext.convnext_state_dict_from_jax`` maps it back onto
the port's ``ConvNeXtV2``. The config readers are copies of the JAX
package's ``infer_convnext_config`` (the official FCMAE
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
from path_gene_multimodal_tpu_torch.models.weights import _np


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


def _take_conv(sd: Mapping, key: str, consumed: set[str]) -> dict:
    """A torch conv → flax ``{"kernel": HWIO[, "bias"]}``, its keys consumed.
    A depthwise (C, 1, kh, kw) takes the same permutation to flax's
    feature_group_count layout."""
    out = {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    consumed.add(f"{key}.weight")
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
        consumed.add(f"{key}.bias")
    return out


def _take_ln(sd: Mapping, key: str, consumed: set[str]) -> dict:
    consumed.update({f"{key}.weight", f"{key}.bias"})
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _take_dense(sd: Mapping, key: str, consumed: set[str]) -> dict:
    """A torch Linear (out, in) → flax ``{"kernel": (in, out)[, "bias"]}``."""
    out = {"kernel": _np(sd[f"{key}.weight"]).T}
    consumed.add(f"{key}.weight")
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
        consumed.add(f"{key}.bias")
    return out


def convert_convnextv2(
    sd: Mapping[str, np.ndarray], cfg: ConvNeXtConfig | None = None
) -> tuple[dict, dict]:
    """FCMAE-named ConvNeXtV2 → ({"params": encoder_params}, unconsumed_keys),
    after stripping a ``module.`` / ``encoder.`` / ``backbone.`` / ``model.``
    prefix."""
    for prefix in ("module.", "encoder.", "backbone.", "model."):
        if any(k.startswith(prefix + "downsample_layers") for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    if cfg is None:
        cfg = infer_convnext_config(sd)
    consumed: set[str] = set()
    p: dict = {
        "stem_conv": _take_conv(sd, "downsample_layers.0.0", consumed),
        "stem_norm": _take_ln(sd, "downsample_layers.0.1", consumed),
    }
    for s in range(1, cfg.num_stages):
        p[f"down{s}_norm"] = _take_ln(sd, f"downsample_layers.{s}.0", consumed)
        p[f"down{s}_conv"] = _take_conv(sd, f"downsample_layers.{s}.1", consumed)
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            t = f"stages.{s}.{b}"
            p[f"stage{s}_block{b}"] = {
                "dwconv": _take_conv(sd, f"{t}.dwconv", consumed),
                "norm": _take_ln(sd, f"{t}.norm", consumed),
                "pwconv1": _take_dense(sd, f"{t}.pwconv1", consumed),
                "pwconv2": _take_dense(sd, f"{t}.pwconv2", consumed),
                "grn": {
                    "gamma": _np(sd[f"{t}.grn.gamma"]).reshape(-1),
                    "beta": _np(sd[f"{t}.grn.beta"]).reshape(-1),
                },
            }
            consumed.update({f"{t}.grn.gamma", f"{t}.grn.beta"})
    unconsumed = {k: v for k, v in sd.items() if k not in consumed}
    return {"params": p}, unconsumed
