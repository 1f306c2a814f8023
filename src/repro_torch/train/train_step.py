"""Train step: loss + grads + optimizer, with microbatching (PyTorch port of
``repro/train/train_step.py``).

One card, no mesh: the cross-pod compressed gradient reduction
(``compress_pod_grads``) needs a 'pod' mesh axis and raises, as the
reference does without one; its port belongs to the distributed slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.models.model import Model
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1              # grad accumulation steps
    compress_pod_grads: bool = False   # int8 error-feedback across 'pod'


def make_train_state(model: Model, opt_cfg: adamw.AdamWConfig,
                     gen: torch.Generator,
                     settings: TrainSettings | None = None) -> dict:
    if settings and settings.compress_pod_grads:
        raise ValueError("compress_pod_grads requires a mesh with a 'pod' "
                         "axis")
    params = model.init(gen)
    return {"params": params,
            "opt": adamw.init_state(opt_cfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """Microbatch i holds rows [i B/n, (i + 1) B/n), the reference's
    ``reshape(n, B // n, ...)``."""
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _value_and_grad(model: Model, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = model.train_loss(tree.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(params, list(grads))


def _loss_and_grads(model: Model, params, batch, n_micro: int):
    """(loss, grads): the grads of a bfloat16 parameter arrive in bfloat16,
    as ``jax.grad``'s do; with microbatches they accumulate in float32 and
    are scaled by 1/n."""
    if n_micro == 1:
        return _value_and_grad(model, params, batch)
    loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
    grad_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in tree.leaves(params)]
    for mb in _split_microbatches(batch, n_micro):
        loss, grads = _value_and_grad(model, params, mb)
        loss_acc = loss_acc + loss
        for acc, g in zip(grad_acc, tree.leaves(grads)):
            acc.add_(g)
    inv = 1.0 / n_micro
    return loss_acc * inv, tree.unflatten(params,
                                          [g * inv for g in grad_acc])


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    settings: TrainSettings = TrainSettings()):
    """The train step ``(state, batch) -> (state, metrics)``.

    ``batch`` holds numpy or torch ``tokens`` (B, T).  The loss and all
    gradients are computed before anything is written, so a failure in the
    forward or the backward leaves ``state`` as it was (the trainer's retry
    relies on that).  The optimizer update itself is in place: the returned
    state holds the same parameter and moment tensors, updated, and a
    failure once it began writing raises ``adamw.PartialUpdateError``,
    which the trainer does not retry.

    The dense and MoE families train; under remat "dots" each layer (or
    llama4's group of layers) saves the outputs of its ``aten.mm`` /
    ``aten.addmm`` products (the projections, the MoE router and shared
    MLP) and recomputes the rest in the backward: attention (the flash
    op), the experts' grouped ``aten.bmm`` products, the dispatch and the
    elementwise work.
    """
    if settings.compress_pod_grads:
        raise ValueError("compress_pod_grads requires a mesh with a 'pod' "
                         "axis")
    if model.cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"training covers the dense and MoE families; {model.cfg.name} "
            f"({model.cfg.family}) needs a backward for its scan kernel, "
            "which is not ported yet (ROADMAP.md Queue 1 item 5b)")

    def step(state, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        loss, grads = _loss_and_grads(model, state["params"], batch,
                                      settings.microbatches)
        params, opt, metrics = adamw.apply_updates(
            opt_cfg, state["params"], grads, state["opt"])
        new_state = dict(state, params=params, opt=opt,
                         step=state["step"] + 1)
        return new_state, {"loss": loss, **metrics}

    return step
