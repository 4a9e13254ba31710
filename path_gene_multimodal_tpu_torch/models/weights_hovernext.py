"""HoverNeXt weights between the canonical torch names and the JAX
package's flax layout, and a torch-named state dict's shapes →
``HoverNeXtConfig``.

``convert_hovernext`` is a copy of the JAX package's
(``models/weights_hovernext.py``): the canonical layout (``encoder.*`` in
FCMAE naming, ``decoder.I.convJ|normJ.*``, ``final_conv.*``,
``head_np|hv|tp.*``, the port's own ``state_dict()`` keys) → (config,
``{"params": ...}``, unconsumed keys), what ``cli/convert_weights`` writes.
``params_from_jax`` is its inverse: it takes the JAX package's parameter
tree, given as numpy arrays (``{"params": {...}}`` or the inner dict), and
returns the torch-named ``state_dict`` of ``models.hovernext.HoverNeXt``;
``convnext_state_dict_from_jax`` does the same for a bare encoder tree
(kind ``convnext``). Conv kernels go HWIO → OIHW, dense kernels (in, out) →
(out, in), LayerNorm ``scale`` → ``weight``, GRN vectors → (1, 1, 1, C).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.weights_convnext import (
    _take_conv,
    _take_ln,
    convert_convnextv2,
    infer_convnext_config,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p: Mapping, key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _dense(p: Mapping, key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def _ln(p: Mapping, key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def convnext_state_dict_from_jax(enc: Mapping, cfg: ConvNeXtConfig,
                                 prefix: str = "") -> dict[str, torch.Tensor]:
    """JAX ConvNeXtV2 encoder params (numpy leaves; ``{"params": ...}`` or
    the inner dict) → the FCMAE-named state dict of the port's
    ``models.convnext.ConvNeXtV2``, each key under ``prefix``."""
    enc = enc["params"] if "params" in enc else enc
    sd: dict[str, torch.Tensor] = {}
    _conv(enc["stem_conv"], f"{prefix}downsample_layers.0.0", sd)
    _ln(enc["stem_norm"], f"{prefix}downsample_layers.0.1", sd)
    for s in range(1, cfg.num_stages):
        _ln(enc[f"down{s}_norm"], f"{prefix}downsample_layers.{s}.0", sd)
        _conv(enc[f"down{s}_conv"], f"{prefix}downsample_layers.{s}.1", sd)
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            blk, t = enc[f"stage{s}_block{b}"], f"{prefix}stages.{s}.{b}"
            _conv(blk["dwconv"], f"{t}.dwconv", sd)
            _ln(blk["norm"], f"{t}.norm", sd)
            _dense(blk["pwconv1"], f"{t}.pwconv1", sd)
            sd[f"{t}.grn.gamma"] = _t(blk["grn"]["gamma"]).reshape(1, 1, 1, -1)
            sd[f"{t}.grn.beta"] = _t(blk["grn"]["beta"]).reshape(1, 1, 1, -1)
            _dense(blk["pwconv2"], f"{t}.pwconv2", sd)
    return sd


def params_from_jax(flax_params: Mapping, cfg: HoverNeXtConfig) -> dict[str, torch.Tensor]:
    """JAX HoverNeXt params (numpy leaves) → torch ``state_dict``."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    sd = convnext_state_dict_from_jax(p["encoder"], cfg.encoder, prefix="encoder.")
    for i in range(len(cfg.decoder_dims)):
        dp = p[f"dec{i}"]
        for j in range(2):
            _conv(dp[f"conv{j}"], f"decoder.{i}.conv{j}", sd)
            _ln(dp[f"norm{j}"], f"decoder.{i}.norm{j}", sd)
    for name in ("final_conv", "head_np", "head_hv", "head_tp"):
        _conv(p[name], name, sd)
    return sd


def infer_hovernext_config(
    sd: Mapping[str, np.ndarray], input_size: int = 256
) -> HoverNeXtConfig:
    """Derive a HoverNeXtConfig from a layout-matching state dict's shapes
    (a copy of the JAX package's ``infer_hovernext_config``)."""
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    if not enc_sd:
        raise ValueError("no 'encoder.*' keys in state dict")
    enc = infer_convnext_config(enc_sd)
    dims = []
    i = 0
    while f"decoder.{i}.conv0.weight" in sd:
        dims.append(int(np.shape(sd[f"decoder.{i}.conv0.weight"])[0]))
        i += 1
    if not dims:
        raise ValueError("no 'decoder.I.conv0.*' keys in state dict")
    if len(dims) != enc.num_stages:
        raise ValueError(
            f"decoder has {len(dims)} levels but encoder has {enc.num_stages} stages"
        )
    if "head_tp.weight" not in sd:
        raise ValueError("missing 'head_tp.weight'")
    num_types = int(np.shape(sd["head_tp.weight"])[0]) - 1
    return HoverNeXtConfig(
        encoder=enc,
        decoder_dims=tuple(dims),
        num_types=num_types,
        input_size=input_size,
    )


def convert_hovernext(
    sd: Mapping[str, np.ndarray], cfg: HoverNeXtConfig | None = None
) -> tuple[HoverNeXtConfig, dict, dict]:
    """Full canonical HoverNeXt state dict → (cfg, {"params": ...},
    unconsumed_keys), after stripping a ``module.`` / ``model.`` wrapper."""
    for prefix in ("module.", "model."):
        if any(k.startswith(prefix + "encoder.") for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    if cfg is None:
        cfg = infer_hovernext_config(sd)

    enc_sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    enc_vars, enc_left = convert_convnextv2(enc_sd, cfg.encoder)
    consumed: set[str] = {f"encoder.{k}" for k in enc_sd if k not in enc_left}

    p: dict = {"encoder": enc_vars["params"]}
    for i in range(len(cfg.decoder_dims)):
        p[f"dec{i}"] = {
            "conv0": _take_conv(sd, f"decoder.{i}.conv0", consumed),
            "norm0": _take_ln(sd, f"decoder.{i}.norm0", consumed),
            "conv1": _take_conv(sd, f"decoder.{i}.conv1", consumed),
            "norm1": _take_ln(sd, f"decoder.{i}.norm1", consumed),
        }
    for name in ("final_conv", "head_np", "head_hv", "head_tp"):
        p[name] = _take_conv(sd, name, consumed)

    unconsumed = {k: v for k, v in sd.items() if k not in consumed}
    return cfg, {"params": p}, unconsumed
