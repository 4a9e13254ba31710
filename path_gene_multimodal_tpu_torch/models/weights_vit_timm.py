"""timm ViT (Virchow2) checkpoints: the layout test, the config read from
a checkpoint's shapes, and the JAX package's parameters → the port's
``state_dict``.

``is_timm_vit_layout`` and ``infer_timm_vit_config`` are copies of the JAX
package's (``models/weights.py:215-278``). The port's ``TimmViT`` carries
timm's own names, so a checkpoint needs no renaming: ``timm_state_dict``
strips a ``module.`` / ``model.`` wrapper and gives the tokens timm's
shapes. ``timm_state_dict_from_jax`` is the inverse of the JAX package's
``convert_timm_vit``: the patch kernel (kh, kw, cin, cout) → (cout, cin,
kh, kw), dense kernels (in, out) → (out, in), LayerNorm ``scale`` →
``weight``, and the cls / register tokens and the position embedding as
(1, n, width).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.models.vit_timm import _HEADS_BY_WIDTH, TimmViTConfig
from path_gene_multimodal_tpu_torch.utils.log import get_logger


def is_timm_vit_layout(sd: Mapping[str, np.ndarray]) -> bool:
    """True for timm VisionTransformer naming (the real Virchow2 layout:
    ``blocks.N.attn.qkv`` + ``patch_embed.proj``)."""
    return "patch_embed.proj.weight" in sd and any(k.startswith("blocks.0.attn.qkv.") for k in sd)


def infer_timm_vit_config(sd: Mapping[str, np.ndarray]) -> TimmViTConfig:
    """TimmViTConfig from a timm ViT checkpoint's shapes (Virchow2:
    ViT-H/14, 4 registers, SwiGLU 5.3375, LayerScale). The head count is
    the one hyperparameter the shapes cannot give: it comes from
    ``_HEADS_BY_WIDTH``, else width // 64 with a warning."""
    width, _, patch, _ = sd["patch_embed.proj.weight"].shape
    layers = max(int(k.split(".")[1]) for k in sd if k.startswith("blocks.")) + 1
    regs = int(sd["reg_token"].shape[1]) if "reg_token" in sd else 0
    n_pos = int(sd["pos_embed"].shape[-2])
    g = int(round(n_pos ** 0.5))
    if g * g == n_pos:
        mode, grid = "patches_only", g
    else:
        g = int(round((n_pos - 1 - regs) ** 0.5))
        if g * g != n_pos - 1 - regs:
            raise ValueError(f"cannot infer grid from pos_embed length {n_pos}")
        mode, grid = "prefix", g
    fc1_out = int(sd["blocks.0.mlp.fc1.weight"].shape[0])
    fc2_in = int(sd["blocks.0.mlp.fc2.weight"].shape[1])
    if fc1_out == 2 * fc2_in:
        mlp_type = "swiglu"
    elif fc1_out == fc2_in:
        mlp_type = "gelu"
    else:
        raise ValueError(f"unrecognized MLP shapes fc1={fc1_out}, fc2_in={fc2_in}")
    if int(width) not in _HEADS_BY_WIDTH:
        get_logger().warning(
            "infer_timm_vit_config: width %d not in the known-heads table %s; ASSUMING "
            "heads=%d (width//64). If the checkpoint uses a different head count, pass an "
            "explicit TimmViTConfig(heads=...).",
            int(width), sorted(_HEADS_BY_WIDTH), max(int(width) // 64, 1),
        )
    return TimmViTConfig(
        image_size=grid * int(patch),
        patch_size=int(patch),
        width=int(width),
        layers=layers,
        heads=_HEADS_BY_WIDTH.get(int(width), max(int(width) // 64, 1)),
        num_registers=regs,
        mlp_hidden=fc1_out,
        mlp_type=mlp_type,
        use_layerscale="blocks.0.ls1.gamma" in sd,
        pos_embed_mode=mode,
    )


def timm_state_dict(sd: Mapping[str, np.ndarray]) -> tuple[TimmViTConfig, dict[str, np.ndarray]]:
    """A timm ViT checkpoint (numpy) → (its config, the state dict in the
    port's names and shapes). Keys it does not know stay in, for a strict
    load to name."""
    for prefix in ("module.", "model."):
        if any(k.startswith(prefix + "patch_embed.") for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    sd = dict(sd)
    cfg = infer_timm_vit_config(sd)
    shapes = {"cls_token": (1, 1, cfg.width), "reg_token": (1, cfg.num_registers, cfg.width),
              "pos_embed": (1, cfg.pos_len, cfg.width)}
    for k, shape in shapes.items():
        if k in sd:
            sd[k] = np.asarray(sd[k]).reshape(shape)
    return cfg, sd


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def timm_state_dict_from_jax(variables: Mapping, cfg: TimmViTConfig) -> dict[str, torch.Tensor]:
    """JAX ``TimmViT`` params (numpy leaves, ``{"params": ...}`` or the
    inner dict) → the port's ``TimmViT`` state dict."""
    p = variables["params"] if "params" in variables else variables
    d = cfg.width
    sd: dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": _t(np.transpose(np.asarray(p["patch_embed"]["kernel"]),
                                                   (3, 2, 0, 1))),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
        "cls_token": _t(np.asarray(p["cls_token"]).reshape(1, 1, d)),
        "pos_embed": _t(np.asarray(p["pos_embed"]).reshape(1, cfg.pos_len, d)),
        "norm.weight": _t(p["norm"]["scale"]),
        "norm.bias": _t(p["norm"]["bias"]),
    }
    if cfg.num_registers:
        sd["reg_token"] = _t(np.asarray(p["reg_token"]).reshape(1, cfg.num_registers, d))
    for i in range(cfg.layers):
        blk, key = p[f"block{i}"], f"blocks.{i}"
        for name, q in (("norm1", blk["norm1"]), ("norm2", blk["norm2"])):
            sd[f"{key}.{name}.weight"] = _t(q["scale"])
            sd[f"{key}.{name}.bias"] = _t(q["bias"])
        for name, q in (("attn.qkv", blk["attn"]["qkv"]), ("attn.proj", blk["attn"]["proj"]),
                        ("mlp.fc1", blk["mlp"]["fc1"]), ("mlp.fc2", blk["mlp"]["fc2"])):
            sd[f"{key}.{name}.weight"] = _t(np.asarray(q["kernel"]).T)
            sd[f"{key}.{name}.bias"] = _t(q["bias"])
        if cfg.use_layerscale:
            sd[f"{key}.ls1.gamma"] = _t(blk["ls1"]["gamma"])
            sd[f"{key}.ls2.gamma"] = _t(blk["ls2"]["gamma"])
    return sd
