"""Safe loading of torch checkpoints (a copy of ``load_torch_checkpoint``
from the JAX package's ``models/weights.py``)."""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch


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
