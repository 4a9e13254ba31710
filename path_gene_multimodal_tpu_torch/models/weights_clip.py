"""JAX CLIP tower parameters → the port's ``state_dict``.

``text_state_dict_from_jax`` is the inverse of the JAX package's
``convert_clip_text`` for the OpenAI layout (``models/weights.py:159``):
token and position embeddings, the blocks as below, ``ln_final`` and the
(width, out) ``text_projection``.

``vision_state_dict_from_jax`` is the inverse of the JAX package's
``convert_clip_vision`` for the OpenAI layout
(``models/weights.py:142-155``, ``_openai_block`` :104-121): it
takes the JAX ``VisionTower`` parameter tree, given as numpy arrays
(``{"params": {...}}`` or the inner dict), and returns the ``visual.*``
``state_dict`` of ``models.clip.VisionTower``. The patch-embed kernel goes
(kh, kw, cin, cout) → (cout, cin, kh, kw), dense kernels (in, out) →
(out, in), q/k/v stack into ``in_proj_weight`` / ``in_proj_bias``,
LayerNorm ``scale`` → ``weight``; ``proj`` stays (width, out), as OpenAI
stores it. Register tokens, which ``convert_clip_vision`` does not read,
become ``visual.register_tokens``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.models.clip import TextConfig, VisionConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ln(p: Mapping, key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _dense(p: Mapping, key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def _blocks(p: Mapping, layers: int, prefix: str, out: dict) -> None:
    for i in range(layers):
        blk, key = p[f"block{i}"], f"{prefix}.resblocks.{i}"
        attn = blk["attn"]
        _ln(blk["ln1"], f"{key}.ln_1", out)
        out[f"{key}.attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(attn[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")]))
        out[f"{key}.attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(attn[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]))
        _dense(attn["out_proj"], f"{key}.attn.out_proj", out)
        _ln(blk["ln2"], f"{key}.ln_2", out)
        _dense(blk["fc1"], f"{key}.mlp.c_fc", out)
        _dense(blk["fc2"], f"{key}.mlp.c_proj", out)


def text_state_dict_from_jax(flax_params: Mapping, cfg: TextConfig) -> dict[str, torch.Tensor]:
    """JAX ``TextTower`` params (numpy leaves) → torch ``state_dict``."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    sd: dict[str, torch.Tensor] = {
        "token_embedding.weight": _t(p["token_embed"]["embedding"]),
        "positional_embedding": _t(p["pos_embed"]),
    }
    _blocks(p["transformer"], cfg.layers, "transformer", sd)
    _ln(p["ln_final"], "ln_final", sd)
    sd["text_projection"] = _t(p["proj"]["kernel"])
    return sd


def vision_state_dict_from_jax(flax_params: Mapping, cfg: VisionConfig) -> dict[str, torch.Tensor]:
    """JAX ``VisionTower`` params (numpy leaves) → torch ``state_dict``."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    sd: dict[str, torch.Tensor] = {
        "visual.conv1.weight": _t(np.transpose(np.asarray(p["patch_embed"]["kernel"]), (3, 2, 0, 1))),
        "visual.class_embedding": _t(p["cls_token"]),
        "visual.positional_embedding": _t(p["pos_embed"]),
    }
    if cfg.num_registers:
        sd["visual.register_tokens"] = _t(p["register_tokens"])
    _ln(p["ln_pre"], "visual.ln_pre", sd)
    _blocks(p["transformer"], cfg.layers, "visual.transformer", sd)
    _ln(p["ln_post"], "visual.ln_post", sd)
    if cfg.out_dim is not None:
        sd["visual.proj"] = _t(p["proj"]["kernel"])
    return sd
