"""JAX fusion parameters → the port's ``state_dict``.

``fusion_state_dict_from_jax`` takes the flax ``FusionHead`` tree
(``proj_hist``, ``proj_gene``, ``fc1``, ``fc2``) and
``pool_state_dict_from_jax`` the flax ``AttentionPool`` tree (``attn_v``,
``attn_u``, ``attn_w``), each as numpy arrays (``{"params": {...}}`` or the
inner dict), and return the ``state_dict`` of ``models.fusion.FusionHead``
/ ``AttentionPool``: each Dense kernel (in, out) transposed into
``nn.Linear.weight`` (out, in), its bias as it is.
"""

from __future__ import annotations

from typing import Mapping

import torch

from path_gene_multimodal_tpu_torch.models.weights_clip import _dense

FUSION_LAYERS = ("proj_hist", "proj_gene", "fc1", "fc2")
POOL_LAYERS = ("attn_v", "attn_u", "attn_w")


def _from_jax(flax_params: Mapping, layers: tuple[str, ...]) -> dict[str, torch.Tensor]:
    p = flax_params.get("params", flax_params)
    out: dict[str, torch.Tensor] = {}
    for name in layers:
        _dense(p[name], name, out)
    return out


def fusion_state_dict_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``FusionHead`` params → ``models.fusion.FusionHead`` state dict."""
    return _from_jax(flax_params, FUSION_LAYERS)


def pool_state_dict_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``AttentionPool`` params → ``models.fusion.AttentionPool`` state
    dict."""
    return _from_jax(flax_params, POOL_LAYERS)
