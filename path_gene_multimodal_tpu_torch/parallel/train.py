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

Data parallelism: JAX's ``shard_step_over_mesh`` wraps an opaque jitted
step and XLA partitions it. Torch cannot partition a closure, so the
port's steps are ``SplitStep``s: the host's draws for the global batch
(``draw``), a loss-and-gradient function over any run of rows
(``loss_grad``: the per-example losses summed and divided by the global
row count, so that the shards' parts sum to the whole batch's mean), and
the update. ``shard_step_over_mesh`` runs ``loss_grad`` on each shard of a
mesh, sums the parts on the mesh's first device (and across processes when
``torch.distributed`` is up), and applies one update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from path_gene_multimodal_tpu_torch.ops.cuda import exact_f32
from path_gene_multimodal_tpu_torch.parallel.mesh import (
    Mesh,
    canonical_device,
    replicate,
    run_sharded,
    tree_to,
)

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


@dataclass
class SplitStep:
    """A functional training step in the parts data parallelism needs.
    Calling it, ``step(state, *batch) → (new state, loss)``, is the
    single-device step over the whole batch.

    - ``draw(state, n) → (aux, rng)``: the step's random draws for a global
      batch of ``n`` rows, made on the host from the state's generator:
      ``aux`` a tensor with a row per batch row (or None), ``rng`` the
      generator's next state (or None when the state keeps none);
    - ``loss_grad(params, aux_rows, *rows, n) → (loss, grads)``: the
      per-example losses of these rows summed and divided by ``n``, the
      global batch's rows, and their gradients;
    - ``update``: one ``adamw_update`` at ``learning_rate``.
    """

    draw: Callable
    loss_grad: Callable
    learning_rate: float
    device: torch.device

    def __call__(self, state, *batch):
        batch = tuple(torch.as_tensor(b, device=self.device) for b in batch)
        n = batch[0].shape[0]
        aux, rng = self.draw(state, n)
        with exact_f32():
            loss, grads = self.loss_grad(state["params"], aux, *batch, n)
            return self.update(state, grads, rng), loss

    def update(self, state, grads, rng):
        params, opt = adamw_update(state["params"], grads, state["opt"], self.learning_rate)
        new = {**state, "params": params, "opt": opt}
        if rng is not None:
            new["rng"] = rng
        return new


def _no_draw(state, n):
    return None, None


def make_linear_probe_step(
    encoder: nn.Module,
    feature_dim: int,
    num_classes: int,
    learning_rate: float = 1e-3,
    train_encoder: bool = False,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
):
    """Returns (init_state(generator), step(state, pixels, labels) →
    (state, loss)). ``encoder`` is a tower on ``device`` whose forward takes
    (B, H, W, 3) normalized pixels (``models.clip.VisionTower``). A step
    that ``shard_step_over_mesh`` runs over a mesh is made with that
    ``mesh``: the tower is replicated on each of its devices.

    ``train_encoder=False`` freezes the tower (linear probe): its forward
    runs under ``no_grad`` in the tower's own dtype (bf16 works), and
    gradients reach only the head. ``True`` adds the tower's parameters
    (``encoder.`` + its ``state_dict`` names) to the trained parameters and
    the optimiser, as the JAX step does. The head is f32 (``w`` (feature_dim, classes),
    ``b``; ``head.w`` and ``head.b`` in the state); the step runs without
    TF32.
    """
    dev = canonical_device(device)

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

    encoders = replicate(encoder, Mesh((dev, *(mesh.devices if mesh is not None else ()))))

    def loss_grad(params, _aux, pixels, labels, n):
        if pixels.device not in encoders:
            raise ValueError(f"the probe's tower has no replica on {pixels.device}: "
                             "make the step with the mesh it runs over (mesh=)")
        enc = encoders[pixels.device]

        def loss_of(p):
            if train_encoder:
                own = {k[len("encoder."):]: v for k, v in p.items() if k.startswith("encoder.")}
                feats = functional_call(enc, own, (pixels,))
            else:
                with torch.no_grad():
                    feats = enc(pixels)
            logits = feats.float() @ p["head.w"] + p["head.b"]
            return F.cross_entropy(logits, labels.long(), reduction="sum") / n

        return value_and_grad(loss_of, params)

    step = SplitStep(_no_draw, loss_grad, learning_rate, dev)
    return init_state, step



def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _rank_rows(n_local: int, device: torch.device) -> tuple[list[int], int]:
    """Every process's row count and this one's rank ([n_local], 0 alone)."""
    if not _distributed():
        return [n_local], 0
    import torch.distributed as dist

    dev = device if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([n_local], dtype=torch.int64, device=dev)
    rows = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    return [int(r) for r in rows], dist.get_rank()


def _all_reduce_sum(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The tensors summed over the processes, in one all-reduce (through
    the host under gloo)."""
    if not _distributed():
        return tensors
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    buf = flat if dist.get_backend() == "nccl" else flat.cpu()
    dist.all_reduce(buf)
    flat = buf.to(flat.device)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo : lo + t.numel()].view(t.shape).to(t.dtype))
        lo += t.numel()
    return out


def shard_step_over_mesh(step: SplitStep, mesh: Mesh, state: dict):
    """Data-parallel ``step`` over ``mesh`` → (run, state): the state on the
    mesh's first device, and ``run(state, *batch) → (new state, loss)``.
    Each call draws the step's randomness for the global batch (every
    process's rows when ``torch.distributed`` is up) and takes this
    process's rows of it, so that the masks are the single-device run's;
    copies the parameters to each mesh device, runs ``loss_grad`` on each
    shard's rows there, sums the losses and gradients on the first device
    and across the processes, and applies one update. Works for any step
    arity: each batch argument splits on its leading axis."""
    first = mesh.devices[0]
    # the dropout generator's state stays on the host
    state = {k: v if k == "rng" else tree_to(v, first) for k, v in state.items()}

    def run(state, *batch):
        batch = tuple(torch.as_tensor(b) for b in batch)
        n_local = batch[0].shape[0]
        rows, rank = _rank_rows(n_local, first)
        n = sum(rows)
        aux, rng = step.draw(state, n)
        lead = [] if aux is None else [aux[sum(rows[:rank]) : sum(rows[:rank]) + n_local]]
        params = replicate(state["params"], mesh)

        def shard(dev, *rows_):
            aux_rows, rest = (rows_[0], rows_[1:]) if lead else (None, rows_)
            with exact_f32():
                return step.loss_grad(params[dev], aux_rows, *rest, n)

        parts = run_sharded(mesh, shard, *lead, *batch)
        loss = sum(p[0].to(first) for p in parts)
        keys = list(parts[0][1])
        grads = [sum(p[1][k].to(first) for p in parts) for k in keys]
        loss, *grads = _all_reduce_sum([loss, *grads])
        with exact_f32():
            return step.update(state, dict(zip(keys, grads)), rng), loss

    return run, state

