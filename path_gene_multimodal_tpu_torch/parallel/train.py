"""Training steps: the linear probe (or full fine-tune) of the tile
encoder, and the AdamW update the port's trainers share.

Counterpart of the JAX package's ``parallel/train.py``: the framework's
supervised tile-classifier path, a linear probe (or full fine-tune) of the
tile encoder against the 5-class labels. The step is functional, as the
JAX one: ``step(state, pixels, labels)`` returns a new state and leaves the
old one as it was, so that a state kept aside (a checkpoint's) stays valid.

``adamw_init`` / ``adamw_update`` are ``optax.adamw`` (0.2.6) op for op:
b1 0.9, b2 0.999, eps 1e-8 outside the square root, the bias corrections
divided into both moments, weight decay 1e-4 added to the update of every
parameter (biases included), then the step of ``-learning_rate``.
``torch.optim.AdamW`` differs in its defaults (weight decay 1e-2) and in
where it rounds (the decay before the moments, the bias corrections folded
into the step size). Parameters whose gradient sits near zero can still
step the other way from JAX's when the gradients differ in their last bits.

``shard_step_over_mesh`` (the data-parallel wrapper) is not ported yet
(ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from path_gene_multimodal_tpu_torch.ops.cuda import exact_f32

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4  # optax.adamw's defaults


def adamw_init(params: dict[str, torch.Tensor]) -> dict[str, Any]:
    """optax's AdamW state: the step count and both moments, zero, on the
    parameters' device."""
    dev = next(iter(params.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt: dict[str, Any], learning_rate: float
                 ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """One ``optax.adamw(learning_rate)`` update → (new params, new state),
    new tensors throughout."""
    count = opt["count"] + 1
    t = count.to(torch.float32)
    bc1, bc2 = 1 - torch.full_like(t, B1) ** t, 1 - torch.full_like(t, B2) ** t
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = (1 - B1) * g + B1 * opt["mu"][k]
        nu[k] = (1 - B2) * (g * g) + B2 * opt["nu"][k]
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
        u = u + WEIGHT_DECAY * p
        new_p[k] = p + (-learning_rate) * u
    return new_p, {"count": count, "mu": mu, "nu": nu}


def value_and_grad(loss_of: Callable[[dict], torch.Tensor], params: dict[str, torch.Tensor]
           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, d loss / d params) at ``params``, which stay untouched."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_of(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_linear_probe_step(
    encoder: nn.Module,
    feature_dim: int,
    num_classes: int,
    learning_rate: float = 1e-3,
    train_encoder: bool = False,
    device: str | torch.device = "cuda",
):
    """Returns (init_state(generator), step(state, pixels, labels) →
    (state, loss)). ``encoder`` is a tower on ``device`` whose forward takes
    (B, H, W, 3) normalized pixels (``models.clip.VisionTower``).

    ``train_encoder=False`` freezes the tower (linear probe): its forward
    runs under ``no_grad`` in the tower's own dtype (bf16 works), and
    gradients reach only the head. ``True`` adds the tower's parameters
    (``encoder.`` + its ``state_dict`` names) to the trained parameters and
    the optimiser, as the JAX step does. The head is f32 (``w`` (feature_dim, classes),
    ``b``; ``head.w`` and ``head.b`` in the state); the step runs without
    TF32.
    """
    dev = torch.device(device)

    def init_state(generator: torch.Generator) -> dict[str, Any]:
        """``w`` ~ N(0, 0.02²) drawn on the host from ``generator`` (not
        JAX's PRNG draw), ``b`` zero."""
        head = {"w": (torch.randn((feature_dim, num_classes), generator=generator) * 0.02).to(dev),
                "b": torch.zeros((num_classes,), device=dev)}
        params = {f"head.{k}": v for k, v in head.items()}
        if train_encoder:
            params.update({f"encoder.{k}": v.detach().clone()
                           for k, v in encoder.named_parameters()})
        return {"params": params, "opt": adamw_init(params)}

    def loss_of(params, pixels, labels):
        if train_encoder:
            enc = {k[len("encoder."):]: v for k, v in params.items() if k.startswith("encoder.")}
            feats = functional_call(encoder, enc, (pixels,))
        else:
            with torch.no_grad():
                feats = encoder(pixels)
        logits = feats.float() @ params["head.w"] + params["head.b"]
        return F.cross_entropy(logits, labels.long())

    def step(state, pixels, labels):
        pixels = torch.as_tensor(pixels, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        with exact_f32():
            loss, grads = value_and_grad(lambda p: loss_of(p, pixels, labels), state["params"])
            params, opt = adamw_update(state["params"], grads, state["opt"], learning_rate)
        return {"params": params, "opt": opt}, loss

    return init_state, step

