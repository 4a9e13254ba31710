"""Safe loading of torch checkpoints and the CLIP converters: copies of the
JAX package's ``models/weights.py`` (``load_torch_checkpoint``,
``convert_clip_vision`` / ``convert_clip_text`` and their config
inference). The timm ViT's converters live in ``models/weights_vit_timm.py``."""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.models.clip import TextConfig, VisionConfig


def _np(t) -> np.ndarray:
    """torch tensor / array → numpy float32 (bf16 checkpoints upcast)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def load_torch_checkpoint(
    path: str | Path, allow_pickle: bool = False
) -> dict[str, np.ndarray]:
    """Load a torch checkpoint safely.

    Published checkpoints are untrusted downloads: unpickling arbitrary
    objects is code execution, so this loads with ``weights_only=True``
    (plain state dicts load fine). Pass ``allow_pickle=True`` only for
    checkpoints you trust: it falls back to a full unpickle with a loud
    warning. A ``state_dict`` or ``model`` entry holding a dict is
    unwrapped, as is an object with a ``state_dict()`` method."""
    try:
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        warnings.warn(
            f"{path}: weights_only load failed; falling back to full unpickling "
            "(allow_pickle=True). Only do this for trusted files — unpickling can "
            "execute arbitrary code.",
            stacklevel=2,
        )
        sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: _np(v) for k, v in sd.items() if hasattr(v, "shape")}


# ---------------------------------------------------------------------------
# torch CLIP state dicts → the JAX package's flax-layout parameter trees
# ---------------------------------------------------------------------------
# Copies of the JAX package's numpy converters (``models/weights.py``): the
# trees they return are what ``core.checkpoints.save_converted`` writes, and
# ``models.weights_clip`` maps them onto the port's own towers. Conv (O, I,
# kh, kw) → (kh, kw, I, O); Linear (O, I) → kernel (I, O); LayerNorm weight
# / bias → scale / bias. Both CLIP namings: transformers ``CLIPModel``
# (``vision_model.encoder.layers.N...``) and OpenAI (``visual.transformer.
# resblocks.N...`` with a fused ``in_proj_weight``).


def _linear(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _hf_block(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {
        "ln1": _ln(sd, f"{prefix}.layer_norm1"),
        "ln2": _ln(sd, f"{prefix}.layer_norm2"),
        "attn": {
            "q_proj": _linear(sd, f"{prefix}.self_attn.q_proj"),
            "k_proj": _linear(sd, f"{prefix}.self_attn.k_proj"),
            "v_proj": _linear(sd, f"{prefix}.self_attn.v_proj"),
            "out_proj": _linear(sd, f"{prefix}.self_attn.out_proj"),
        },
        "fc1": _linear(sd, f"{prefix}.mlp.fc1"),
        "fc2": _linear(sd, f"{prefix}.mlp.fc2"),
    }


def _openai_block(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    w = _np(sd[f"{prefix}.attn.in_proj_weight"])  # (3d, d)
    b = _np(sd[f"{prefix}.attn.in_proj_bias"])
    d = w.shape[1]
    qw, kw, vw = w[:d], w[d : 2 * d], w[2 * d :]
    qb, kb, vb = b[:d], b[d : 2 * d], b[2 * d :]
    return {
        "ln1": _ln(sd, f"{prefix}.ln_1"),
        "ln2": _ln(sd, f"{prefix}.ln_2"),
        "attn": {
            "q_proj": {"kernel": qw.T, "bias": qb},
            "k_proj": {"kernel": kw.T, "bias": kb},
            "v_proj": {"kernel": vw.T, "bias": vb},
            "out_proj": _linear(sd, f"{prefix}.attn.out_proj"),
        },
        "fc1": _linear(sd, f"{prefix}.mlp.c_fc"),
        "fc2": _linear(sd, f"{prefix}.mlp.c_proj"),
    }


def convert_clip_vision(sd: Mapping[str, np.ndarray], cfg: VisionConfig) -> dict:
    """CLIP vision-tower state dict → ``{"params": ...}`` of the JAX
    package's ``VisionTower``."""
    hf = any(k.startswith("vision_model.") for k in sd)
    p: dict = {}
    if hf:
        p["patch_embed"] = {
            "kernel": _np(sd["vision_model.embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)
        }
        p["cls_token"] = _np(sd["vision_model.embeddings.class_embedding"]).reshape(-1)
        p["pos_embed"] = _np(sd["vision_model.embeddings.position_embedding.weight"])
        p["ln_pre"] = _ln(sd, "vision_model.pre_layrnorm")
        p["transformer"] = {
            f"block{i}": _hf_block(sd, f"vision_model.encoder.layers.{i}")
            for i in range(cfg.layers)
        }
        p["ln_post"] = _ln(sd, "vision_model.post_layernorm")
        if cfg.out_dim is not None and "visual_projection.weight" in sd:
            p["proj"] = {"kernel": _np(sd["visual_projection.weight"]).T}
    else:
        p["patch_embed"] = {"kernel": _np(sd["visual.conv1.weight"]).transpose(2, 3, 1, 0)}
        p["cls_token"] = _np(sd["visual.class_embedding"]).reshape(-1)
        p["pos_embed"] = _np(sd["visual.positional_embedding"])
        p["ln_pre"] = _ln(sd, "visual.ln_pre")
        p["transformer"] = {
            f"block{i}": _openai_block(sd, f"visual.transformer.resblocks.{i}")
            for i in range(cfg.layers)
        }
        p["ln_post"] = _ln(sd, "visual.ln_post")
        if cfg.out_dim is not None and "visual.proj" in sd:
            p["proj"] = {"kernel": _np(sd["visual.proj"])}  # already (width, out)
    return {"params": p}


def convert_clip_text(sd: Mapping[str, np.ndarray], cfg: TextConfig) -> dict:
    """CLIP text-tower state dict → ``{"params": ...}`` of the JAX
    package's ``TextTower``."""
    hf = any(k.startswith("text_model.") for k in sd)
    p: dict = {}
    if hf:
        p["token_embed"] = {"embedding": _np(sd["text_model.embeddings.token_embedding.weight"])}
        p["pos_embed"] = _np(sd["text_model.embeddings.position_embedding.weight"])
        p["transformer"] = {
            f"block{i}": _hf_block(sd, f"text_model.encoder.layers.{i}")
            for i in range(cfg.layers)
        }
        p["ln_final"] = _ln(sd, "text_model.final_layer_norm")
        p["proj"] = {"kernel": _np(sd["text_projection.weight"]).T}
    else:
        p["token_embed"] = {"embedding": _np(sd["token_embedding.weight"])}
        p["pos_embed"] = _np(sd["positional_embedding"])
        p["transformer"] = {
            f"block{i}": _openai_block(sd, f"transformer.resblocks.{i}")
            for i in range(cfg.layers)
        }
        p["ln_final"] = _ln(sd, "ln_final")
        p["proj"] = {"kernel": _np(sd["text_projection"])}  # (width, out)
    return {"params": p}


def _max_index(sd: Mapping, prefix: str, part: int) -> int:
    return max(int(k.split(".")[part]) for k in sd if k.startswith(prefix)) + 1


def infer_text_config(sd: Mapping[str, np.ndarray]) -> TextConfig:
    """A ``TextConfig`` from a CLIP checkpoint's shapes (heads: width // 64)."""
    hf = any(k.startswith("text_model.") for k in sd)
    if hf:
        vocab, width = sd["text_model.embeddings.token_embedding.weight"].shape
        ctx = sd["text_model.embeddings.position_embedding.weight"].shape[0]
        layers = _max_index(sd, "text_model.encoder.layers.", 3)
        out_dim = int(sd["text_projection.weight"].shape[0])
        fc1_key = "text_model.encoder.layers.0.mlp.fc1.weight"
    else:
        vocab, width = sd["token_embedding.weight"].shape
        ctx = sd["positional_embedding"].shape[0]
        layers = _max_index(sd, "transformer.resblocks.", 2)
        out_dim = int(sd["text_projection"].shape[1])
        fc1_key = "transformer.resblocks.0.mlp.c_fc.weight"
    ratio = float(sd[fc1_key].shape[0]) / float(width)
    return TextConfig(
        vocab_size=int(vocab), context_length=int(ctx), width=int(width),
        layers=layers, heads=max(int(width) // 64, 1), mlp_ratio=ratio,
        out_dim=out_dim,
    )


def infer_vision_config(sd: Mapping[str, np.ndarray]) -> VisionConfig:
    """A ``VisionConfig`` from a CLIP checkpoint's shapes (heads: width // 64)."""
    hf = any(k.startswith("vision_model.") for k in sd)
    if hf:
        width, _, patch, _ = sd["vision_model.embeddings.patch_embedding.weight"].shape
        n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
        layers = _max_index(sd, "vision_model.encoder.layers.", 3)
        out_dim = (int(sd["visual_projection.weight"].shape[0])
                   if "visual_projection.weight" in sd else None)
        fc1_key = "vision_model.encoder.layers.0.mlp.fc1.weight"
    else:
        width, _, patch, _ = sd["visual.conv1.weight"].shape
        n_pos = sd["visual.positional_embedding"].shape[0]
        layers = _max_index(sd, "visual.transformer.resblocks.", 3)
        out_dim = int(sd["visual.proj"].shape[1]) if "visual.proj" in sd else None
        fc1_key = "visual.transformer.resblocks.0.mlp.c_fc.weight"
    ratio = float(sd[fc1_key].shape[0]) / float(width)
    grid = int(round((n_pos - 1) ** 0.5))
    return VisionConfig(
        image_size=grid * int(patch),
        patch_size=int(patch),
        width=int(width),
        layers=layers,
        heads=int(width) // 64,
        mlp_ratio=ratio,
        out_dim=out_dim,
    )
