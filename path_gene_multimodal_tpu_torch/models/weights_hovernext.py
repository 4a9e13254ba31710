"""JAX HoverNeXt parameters → the port's ``state_dict``.

The inverse of the JAX package's ``convert_hovernext``
(``models/weights_hovernext.py``): it takes the JAX package's parameter
tree, given as numpy arrays (``{"params": {...}}`` or the inner dict), and
returns the torch-named ``state_dict`` of ``models.hovernext.HoverNeXt``.
Conv kernels go HWIO → OIHW, dense kernels (in, out) → (out, in), LayerNorm
``scale`` → ``weight``, GRN vectors → (1, 1, 1, C).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import HoverNeXtConfig


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


def params_from_jax(flax_params: Mapping, cfg: HoverNeXtConfig) -> dict[str, torch.Tensor]:
    """JAX HoverNeXt params (numpy leaves) → torch ``state_dict``."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    enc = p["encoder"]
    sd: dict[str, torch.Tensor] = {}
    _conv(enc["stem_conv"], "encoder.downsample_layers.0.0", sd)
    _ln(enc["stem_norm"], "encoder.downsample_layers.0.1", sd)
    for s in range(1, cfg.encoder.num_stages):
        _ln(enc[f"down{s}_norm"], f"encoder.downsample_layers.{s}.0", sd)
        _conv(enc[f"down{s}_conv"], f"encoder.downsample_layers.{s}.1", sd)
    for s in range(cfg.encoder.num_stages):
        for b in range(cfg.encoder.depths[s]):
            blk, t = enc[f"stage{s}_block{b}"], f"encoder.stages.{s}.{b}"
            _conv(blk["dwconv"], f"{t}.dwconv", sd)
            _ln(blk["norm"], f"{t}.norm", sd)
            _dense(blk["pwconv1"], f"{t}.pwconv1", sd)
            sd[f"{t}.grn.gamma"] = _t(blk["grn"]["gamma"]).reshape(1, 1, 1, -1)
            sd[f"{t}.grn.beta"] = _t(blk["grn"]["beta"]).reshape(1, 1, 1, -1)
            _dense(blk["pwconv2"], f"{t}.pwconv2", sd)
    for i in range(len(cfg.decoder_dims)):
        dp = p[f"dec{i}"]
        for j in range(2):
            _conv(dp[f"conv{j}"], f"decoder.{i}.conv{j}", sd)
            _ln(dp[f"norm{j}"], f"decoder.{i}.norm{j}", sd)
    for name in ("final_conv", "head_np", "head_hv", "head_tp"):
        _conv(p[name], name, sd)
    return sd
