"""HoverNeXt checkpoint ingestion: a subset of the JAX package's
``core/checkpoints.py``.

- ``load_hovernext_from_torch``: a torch checkpoint in the canonical layout
  (``encoder.*``, ``decoder.I.convJ|normJ.*``, ``final_conv.*``,
  ``head_np|hv|tp.*``; the JAX package's ``convert_hovernext`` names, which
  are the port's own ``state_dict()`` keys) → (config, state dict);
- ``load_converted``: a ``cli/convert_weights`` ``.npz`` artifact (kind
  ``hovernext``) → (kind, config, numpy params), which
  ``models.weights_hovernext.params_from_jax`` turns into a state dict.

The published smp/timm ``hover_next`` layout is refused: its model
(``models/hovernext_real.py`` in the JAX package) is not ported yet
(ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig

_REAL_LAYOUT = ("the published smp/timm hover_next layout is not ported yet "
                "(ROADMAP Queue 1 item 16)")


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


def load_hovernext_from_torch(
    path: str | Path, allow_pickle: bool = False
) -> tuple[HoverNeXtConfig, dict[str, torch.Tensor]]:
    """A HoverNeXt torch checkpoint in the canonical layout → (config, state
    dict of f32 tensors), the shapes giving the config
    (``infer_hovernext_config``) and the state dict loaded into a
    ``HoverNeXt`` of that config with ``load_state_dict(strict=True)``.

    A checkpoint key that is not consumed raises ``ValueError``, so a naming
    mismatch is loud; a missing key raises too. The published smp/timm
    layout raises ``NotImplementedError``."""
    from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt
    from path_gene_multimodal_tpu_torch.models.weights import load_torch_checkpoint
    from path_gene_multimodal_tpu_torch.models.weights_hovernext import infer_hovernext_config

    sd = load_torch_checkpoint(path, allow_pickle=allow_pickle)
    if _is_real_hovernext_layout(sd):
        raise NotImplementedError(f"{path}: {_REAL_LAYOUT}")
    for prefix in ("module.", "model."):
        if any(k.startswith(prefix + "encoder.") for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    cfg = infer_hovernext_config(sd)
    net = HoverNeXt(cfg)
    expected = net.state_dict()
    leftover = {k: v for k, v in sd.items() if k not in expected}
    if leftover:
        raise ValueError(
            f"{len(leftover)} checkpoint keys were not consumed by the HoverNeXt mapping "
            f"(first 10: {sorted(leftover)[:10]}); re-key the checkpoint to the documented "
            "layout"
        )
    state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()
             if k in expected}
    net.load_state_dict(state, strict=True)
    return cfg, state


def load_converted(path: str | Path) -> tuple[str, Any, Any]:
    """→ (kind, config, variables) of a converted-checkpoint ``.npz``
    (flattened ``p:`` params and a JSON ``__meta__`` record). The port
    reads kind ``hovernext`` (a ``HoverNeXtConfig``); other kinds raise
    ``NotImplementedError``."""
    with np.load(Path(path)) as z:
        if "__meta__" not in z.files:
            raise ValueError(
                f"{path}: not a converted-checkpoint artifact (no __meta__)"
            )
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        flat = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
    return meta["kind"], _config_from_meta(meta["kind"], meta["config"]), _unflatten(flat)


def _config_from_meta(kind: str, d: dict | None) -> Any:
    if kind != "hovernext":
        raise NotImplementedError(f"converted-checkpoint kind {kind!r} is not ported")
    if "branches" in d:
        raise NotImplementedError(_REAL_LAYOUT)
    enc = ConvNeXtConfig(depths=tuple(d["encoder"]["depths"]), dims=tuple(d["encoder"]["dims"]))
    return HoverNeXtConfig(
        encoder=enc,
        decoder_dims=tuple(d["decoder_dims"]),
        num_types=int(d["num_types"]),
        input_size=int(d["input_size"]),
    )
