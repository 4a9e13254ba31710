"""Checkpoint ingestion: a subset of the JAX package's
``core/checkpoints.py``.

- ``file_fingerprint`` and ``text_sidecar_path``: a weights artifact's
  identity for the resume manifests, and where its CLIP text tower rides;
- ``save_params`` / ``load_params``: a training state (a nested dict of
  tensors: parameters, optimiser moments and count, the dropout
  generator's state) to one ``.pt`` file and back, bit for bit. The port's
  own format, where the JAX package writes an orbax directory (or a flat
  ``.npz``): ``torch.save`` of ``{"format": PARAMS_FORMAT, "tensors":
  {"a/b/c": host tensor}}``, the keys the dict path joined by ``/``, read
  back with ``weights_only=True``;

- ``load_hovernext_from_torch``: a HoverNeXt torch checkpoint → (config,
  state dict). The published smp/timm ``hover_next`` layout gives a
  ``RealHoverNeXtConfig`` and a ``models.hovernext_real.RealHoverNeXt``
  state dict; the canonical layout (``encoder.*``,
  ``decoder.I.convJ|normJ.*``, ``final_conv.*``, ``head_np|hv|tp.*``; the
  JAX package's ``convert_hovernext`` names, which are the port's own
  ``state_dict()`` keys) a ``HoverNeXtConfig`` and a ``HoverNeXt`` one;
- ``load_virchow2_from_torch``: a timm ViT checkpoint (the published
  Virchow2 layout) → (``TimmViTConfig``, ``models.vit_timm.TimmViT`` state
  dict);
- ``load_resnet_from_torch``: a torchvision-named ResNet checkpoint (the
  TIAToolbox ``resnet34-idars-*`` layout) → (``ResNetConfig``,
  ``models.resnet.ResNet`` state dict);
- ``load_converted``: a ``cli/convert_weights`` ``.npz`` artifact →
  (kind, config, numpy params): kind ``hovernext`` (a ``HoverNeXtConfig``,
  whose state dict ``models.weights_hovernext.params_from_jax`` makes, or
  with ``branches`` a ``RealHoverNeXtConfig``, whose state dict
  ``models.weights_hovernext_real.real_state_dict_from_jax`` makes),
  ``clip`` / ``clip_text`` (a ``VisionConfig`` / ``TextConfig``;
  ``models.weights_clip`` makes theirs), ``virchow2`` with a timm
  ``TimmViTConfig`` (``models.weights_vit_timm.timm_state_dict_from_jax``)
  or a CLIP-style stand-in ``VisionConfig``, and ``resnet34`` (no config;
  ``models.weights_resnet.resnet_state_dict_from_jax``).

Every loader here loads strict: a checkpoint key the model does not have
raises ``ValueError`` naming it.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import (
    ConvNeXtConfig,
    HoverNeXtConfig,
    RealHoverNeXtConfig,
)

def file_fingerprint(path: str | Path, sample: int = 1 << 20) -> str:
    """Cheap content fingerprint of a weights artifact for resume
    manifests: sha1 over (size, first ``sample`` bytes, last ``sample``
    bytes) — content-sensitive without reading multi-GB files whole."""
    import hashlib

    p = Path(path)
    size = p.stat().st_size
    h = hashlib.sha1(str(size).encode())
    with open(p, "rb") as f:
        h.update(f.read(sample))
        if size > sample:
            f.seek(max(size - sample, 0))
            h.update(f.read(sample))
    return h.hexdigest()[:16]


def text_sidecar_path(artifact: str | Path) -> Path:
    """``<artifact minus a literal .npz>_text.npz`` — where the CLIP text
    tower rides along a converted vision artifact (dotted stems like
    ``clip.v2`` survive; Path.with_suffix would truncate them)."""
    p = Path(artifact)
    name = p.name
    if name.endswith(".npz"):
        name = name[: -len(".npz")]
    return p.parent / f"{name}_text.npz"


PARAMS_FORMAT = "path_gene_multimodal_tpu_torch.params/1"


def flatten_params(tree: Any, prefix: str = "") -> dict[str, Any]:
    """A nested dict → {"a/b/c": leaf}; a key holding ``/`` is refused
    (it would not come back as it went)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in tree.items():
        if "/" in str(k):
            raise ValueError(f"param tree key {k!r} contains '/'; cannot flatten")
        out.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _pt_path(path: Path) -> Path:
    """Append '.pt' without Path.with_suffix, which would truncate dotted
    stems (TCGA slide names hold '.')."""
    return path if path.name.endswith(".pt") else path.parent / (path.name + ".pt")


def save_params(params: Any, path: str | Path) -> Path:
    """Write a nested dict of tensors (any device and dtype) to
    ``<path>.pt`` (through a temporary file, replaced at once); returns the
    file's path."""
    out = _pt_path(Path(path))
    flat = {k: torch.as_tensor(v).detach().cpu() for k, v in flatten_params(params).items()}
    tmp = out.parent / (out.name + ".tmp")
    torch.save({"format": PARAMS_FORMAT, "tensors": flat}, tmp)
    tmp.replace(out)
    return out


def load_params(path: str | Path, like: Any | None = None) -> Any:
    """Read ``save_params``'s file (``path`` with or without ``.pt``). With
    ``like`` (a state of the same tree), every leaf must be there with
    ``like``'s shape and dtype, and goes to ``like``'s leaf's device; a
    missing or extra key raises. Without it, the nested dict on the
    host."""
    path = Path(path)
    if not path.exists():
        path = _pt_path(path)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != PARAMS_FORMAT:
        raise ValueError(f"{path}: not a {PARAMS_FORMAT} file")
    flat = blob["tensors"]
    if like is None:
        return _unflatten(flat)
    want = flatten_params(like)
    if set(want) != set(flat):
        raise ValueError(f"{path}: keys missing {sorted(set(want) - set(flat))}, "
                         f"extra {sorted(set(flat) - set(want))}")
    for k, ref in want.items():
        if flat[k].shape != ref.shape or flat[k].dtype != ref.dtype:
            raise ValueError(f"{path}: {k} is {flat[k].dtype} {tuple(flat[k].shape)}, "
                             f"expected {ref.dtype} {tuple(ref.shape)}")
    return _unflatten({k: flat[k].to(want[k].device) for k in want})


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _is_real_hovernext_layout(sd) -> bool:
    """True for the published smp/timm ``hover_next`` layout (smp decoder
    blocks ``*.blocks.N.conv1.0.weight`` or a timm-universal encoder)."""
    pat = re.compile(r"\.blocks\.\d+\.conv1\.0\.weight$")
    return any(pat.search(k) for k in sd) or any(
        k.startswith(("encoder.model.stem.", "model.encoder.model.stem.")) for k in sd
    )


def _load_strict(net: torch.nn.Module, sd: dict, what: str) -> dict[str, torch.Tensor]:
    """Load ``sd`` (numpy) into ``net`` with ``strict=True``; a key the
    model does not have raises ``ValueError`` naming it, a missing one
    ``RuntimeError`` (torch's)."""
    expected = net.state_dict()
    leftover = sorted(k for k in sd if k not in expected)
    if leftover:
        raise ValueError(
            f"{len(leftover)} checkpoint keys were not consumed by the {what} mapping "
            f"(first 10: {leftover[:10]}); re-key the checkpoint to the documented layout"
        )
    # f32 (a bf16 checkpoint was upcast on load), BatchNorm's counter int64
    state = {k: torch.from_numpy(np.array(v, dtype=np.int64 if k.endswith(
        "num_batches_tracked") else np.float32)) for k, v in sd.items()}
    net.load_state_dict(state, strict=True, assign=True)  # assign: ``net`` may be on meta
    return state


def load_hovernext_from_torch(
    path: str | Path, allow_pickle: bool = False
) -> tuple[HoverNeXtConfig | RealHoverNeXtConfig, dict[str, torch.Tensor]]:
    """A HoverNeXt torch checkpoint → (config, state dict of tensors), the
    config read from the shapes and the state dict loaded into its model
    with ``load_state_dict(strict=True)``: the published smp/timm layout
    (``models.weights_hovernext_real.normalize_real_state_dict``) into a
    ``RealHoverNeXt``, the canonical layout (``infer_hovernext_config``)
    into a ``HoverNeXt``.

    A checkpoint key that is not consumed raises ``ValueError`` naming it,
    so a naming mismatch is loud; a missing key raises ``RuntimeError``."""
    from path_gene_multimodal_tpu_torch.models.weights import load_torch_checkpoint

    sd = load_torch_checkpoint(path, allow_pickle=allow_pickle)
    if _is_real_hovernext_layout(sd):
        from path_gene_multimodal_tpu_torch.models.hovernext_real import RealHoverNeXt
        from path_gene_multimodal_tpu_torch.models.weights_hovernext_real import (
            normalize_real_state_dict,
        )

        cfg, sd = normalize_real_state_dict(sd)
        return cfg, _load_strict(RealHoverNeXt(cfg), sd, "real hover_next")
    from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt
    from path_gene_multimodal_tpu_torch.models.weights_hovernext import infer_hovernext_config

    for prefix in ("module.", "model."):
        if any(k.startswith(prefix + "encoder.") for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    cfg = infer_hovernext_config(sd)
    return cfg, _load_strict(HoverNeXt(cfg), sd, "HoverNeXt")


def load_virchow2_from_torch(
    path: str | Path, allow_pickle: bool = False
) -> tuple[Any, dict[str, torch.Tensor]]:
    """A published Virchow2 checkpoint (timm ViT-H/14 naming: ``cls_token``,
    ``reg_token``, ``blocks.N.attn.qkv``, SwiGLU ``mlp.fc1/fc2``,
    ``ls1/ls2.gamma``) → (``TimmViTConfig`` read from its shapes, state
    dict loaded strict into ``TimmViT``). Reference consumer:
    ``extract_embedding_from_tiles.py:14`` (``MODEL_TYPE="Virchow2"``).
    Build ``models.clip.ImageEncoder`` from both with the ImageNet
    statistics: the tile embedding is concat(cls, patch mean), 2560-d."""
    from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViT
    from path_gene_multimodal_tpu_torch.models.weights import load_torch_checkpoint
    from path_gene_multimodal_tpu_torch.models.weights_vit_timm import timm_state_dict

    cfg, sd = timm_state_dict(load_torch_checkpoint(path, allow_pickle=allow_pickle))
    with torch.device("meta"):
        net = TimmViT(cfg)
    return cfg, _load_strict(net, sd, "timm ViT")


def load_resnet_from_torch(path: str | Path, allow_pickle: bool = False
                           ) -> tuple[Any, dict[str, torch.Tensor]]:
    """A torchvision/TIAToolbox ResNet checkpoint (``resnet34-idars-*``) →
    (``ResNetConfig`` read from its shapes, state dict loaded strict into
    ``models.resnet.ResNet``), after the JAX converter's ``model.`` /
    ``module.`` strip; a missing ``num_batches_tracked`` counter reads as
    0."""
    from path_gene_multimodal_tpu_torch.models.resnet import ResNet, ResNetConfig
    from path_gene_multimodal_tpu_torch.models.weights import load_torch_checkpoint
    from path_gene_multimodal_tpu_torch.models.weights_resnet import strip_prefixes

    sd = strip_prefixes(load_torch_checkpoint(path, allow_pickle=allow_pickle))
    blocks: dict[int, int] = {}
    for k in sd:
        m = re.match(r"layer(\d+)\.(\d+)\.", k)
        if m:
            s_, b = int(m.group(1)), int(m.group(2))
            blocks[s_] = max(blocks.get(s_, 0), b + 1)
    cfg = ResNetConfig(stage_sizes=tuple(blocks[i] for i in sorted(blocks)),
                       num_classes=int(sd["fc.weight"].shape[0]),
                       width=int(sd["conv1.weight"].shape[0]))
    with torch.device("meta"):
        net = ResNet(cfg)
    for k in net.state_dict():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, np.zeros((), np.int64))
    return cfg, _load_strict(net, sd, "ResNet")


def load_converted(path: str | Path) -> tuple[str, Any, Any]:
    """→ (kind, config, variables) of a converted-checkpoint ``.npz``
    (flattened ``p:`` params and a JSON ``__meta__`` record). The port
    reads kinds ``hovernext``, ``clip``, ``clip_text``, ``virchow2`` and
    ``resnet34``; ``convnext`` raises ``NotImplementedError``."""
    with np.load(Path(path)) as z:
        if "__meta__" not in z.files:
            raise ValueError(
                f"{path}: not a converted-checkpoint artifact (no __meta__)"
            )
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        flat = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
    return meta["kind"], _config_from_meta(meta["kind"], meta["config"]), _unflatten(flat)


def _config_from_meta(kind: str, d: dict | None) -> Any:
    if kind == "resnet34":
        return None  # the JAX package stores none: RESNET34_IDARS or the params' shapes
    if kind in ("clip", "clip_text", "virchow2"):
        from dataclasses import fields

        from path_gene_multimodal_tpu_torch.models.clip import TextConfig, VisionConfig
        from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViTConfig

        klass = TextConfig if kind == "clip_text" else VisionConfig
        if kind == "virchow2" and d is not None and "mlp_hidden" in d:
            klass = TimmViTConfig  # the real timm tower, as the JAX package stores it
        if d is None or not set(d) <= {f.name for f in fields(klass)}:
            raise ValueError(f"converted {kind} artifact: config {d} is no {klass.__name__}")
        return klass(**d)
    if kind != "hovernext":
        raise NotImplementedError(f"converted-checkpoint kind {kind!r} is not ported")
    enc = ConvNeXtConfig(depths=tuple(d["encoder"]["depths"]), dims=tuple(d["encoder"]["dims"]))
    if "branches" in d:  # the published smp/timm multi-head layout
        return RealHoverNeXtConfig(
            encoder=enc,
            decoder_channels=tuple(d["decoder_channels"]),
            branches=tuple((a, b, int(c)) for a, b, c in d["branches"]),
            head_upsampling=int(d["head_upsampling"]),
            input_size=int(d["input_size"]),
        )
    return HoverNeXtConfig(
        encoder=enc,
        decoder_dims=tuple(d["decoder_dims"]),
        num_types=int(d["num_types"]),
        input_size=int(d["input_size"]),
    )
