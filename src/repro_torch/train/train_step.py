"""Train step: loss + grads + optimizer, microbatching, and the optional
cross-pod compressed gradient reduction (PyTorch port of
``repro/train/train_step.py``).

``compress_pod_grads`` needs a ``DeviceMesh`` with a 'pod' dimension:
``make_train_step`` raises without one, as the reference does
(``make_train_state`` builds the error state either way).  With one, each rank of the
'pod' group runs the step on its own shard of the batch (the reference's
``P("pod")`` batch spec): the loss is averaged over 'pod' and the gradients
are exchanged as int8 codes with error feedback
(``compression.tree_psum_compressed``), kept in the state's ``grad_err``.

While a ``torch.profiler`` records (the one switch of
``repro_torch.obs.spans``; off, a span is one boolean test), the step
emits the spans ``train.step`` (the whole step), ``train.forward``
(``model.train_loss``, once a microbatch), ``train.backward``
(``torch.autograd.grad``, remat's recompute included, once a microbatch)
and ``train.optimizer`` (``adamw.apply_updates``: the global norm, the
clip and the chunked passes).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core.overlap import compression
from repro_torch.kernels import _symbolic
from repro_torch.models.model import Model
from repro_torch.obs import spans
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1              # grad accumulation steps
    compress_pod_grads: bool = False   # int8 error-feedback across 'pod'


def _pod_group(mesh):
    """The 'pod' dimension's process group; raises without one."""
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        raise ValueError("compress_pod_grads requires a mesh with a 'pod' "
                         "axis")
    return mesh.get_group("pod")


def make_train_state(model: Model, opt_cfg: adamw.AdamWConfig,
                     gen: torch.Generator,
                     settings: TrainSettings | None = None) -> dict:
    compress = bool(settings and settings.compress_pod_grads)
    params = model.init(gen)
    state = {"params": params,
             "opt": adamw.init_state(opt_cfg, params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if compress:
        state["grad_err"] = compression.init_error_state(params)
    return state


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """Microbatch i holds rows [i B/n, (i + 1) B/n), the reference's
    ``reshape(n, B // n, ...)``."""
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _value_and_grad(model: Model, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with spans.span("train.forward", model.device):
        loss = model.train_loss(tree.unflatten(params, leaves), batch)
    with spans.span("train.backward", model.device):
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(params, list(grads))


def _loss_and_grads(model: Model, params, batch, n_micro: int):
    """(loss, grads): the grads of a bfloat16 parameter arrive in bfloat16,
    as ``jax.grad``'s do; with microbatches they accumulate in float32 and
    are scaled by 1/n."""
    if n_micro == 1:
        return _value_and_grad(model, params, batch)
    loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
    grad_acc = [torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
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
                    settings: TrainSettings = TrainSettings(), mesh=None):
    """The train step ``(state, batch) -> (state, metrics)``.

    ``batch`` holds numpy or torch ``tokens`` (B, T).  The loss and all
    gradients are computed before anything is written, so a failure in the
    forward or the backward leaves ``state`` as it was (the trainer's retry
    relies on that).  The optimizer update itself is in place: the returned
    state holds the same parameter and moment tensors, updated, and a
    failure once it began writing raises ``adamw.PartialUpdateError``,
    which the trainer does not retry.

    Every family trains: dense, MoE, VLM, audio, hybrid and SSM (Mamba-1
    and Mamba-2 layers).  The VLM and audio families' ``batch`` also holds
    their ``media`` (B, n_media_tokens, media_embed_dim), which goes to the
    device with the tokens.  Under remat "dots" each layer (or group:
    llama4's dense layers and their MoE layer, the VLM's self layers and
    their cross block, the hybrid's ``attn_every`` Mamba-2 layers and their
    shared block) saves the outputs of its ``aten.mm`` / ``aten.addmm``
    products (the projections, the cross blocks' q/k/v/o projections, the
    MoE router and shared MLP; a Mamba layer's projections) and recomputes
    the rest in the backward: attention (the flash op, self and cross), the
    scans (the ``repro_torch::selective_scan`` and
    ``repro_torch::mamba2_scan`` ops, whose backwards recompute their
    states themselves), the experts' grouped products (the
    ``repro_torch::grouped_mm`` op), the dispatch and the elementwise work (a Mamba layer's causal conv, gates
    and, in Mamba-2, gated norm).  Under remat "full" a layer keeps only
    its input.  ``media @ media_proj`` runs once a step outside the groups
    and, an ``mm``, is kept.
    """
    pod = _pod_group(mesh) if settings.compress_pod_grads else None

    def step(state, batch):
        with spans.span("train.step", model.device):
            return _step(state, batch)

    def _step(state, batch):
        batch = {k: v if _symbolic.symbolic(v) else
                 torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        loss, grads = _loss_and_grads(model, state["params"], batch,
                                      settings.microbatches)
        new_state = dict(state)
        if pod is not None:
            loss = loss.clone()
            dist.all_reduce(loss, group=pod)
            loss = loss / dist.get_world_size(pod)
            grads, new_state["grad_err"] = compression.tree_psum_compressed(
                grads, state["grad_err"], pod)
        with spans.span("train.optimizer", model.device):
            params, opt, metrics = adamw.apply_updates(
                opt_cfg, state["params"], grads, state["opt"])
        new_state.update(params=params, opt=opt, step=state["step"] + 1)
        return new_state, {"loss": loss, **metrics}

    return step
