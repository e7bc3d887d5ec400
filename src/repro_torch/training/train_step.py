"""Causal-LM training step (the train_4k workload shape).

The port of ``repro/training/train_step.py``: the loss is logsumexp - gold
in float32 over ``labels >= 0``; gradients come from
``torch.autograd.grad`` over the parameter leaves in JAX's leaf order; the
update is the in-place AdamW of ``repro_torch.training.optimizer``.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.params import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import adamw_update, cosine_lr


def loss_fn(model: Model, params, tokens, labels, mm_embeds=None):
    """Mean next-token negative log-likelihood over ``labels >= 0``."""
    logits = model.forward_train(params, tokens, mm_embeds=mm_embeds).float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    gold = torch.take_along_dim(
        logits, torch.where(mask, labels, 0).long()[..., None], dim=-1)[..., 0]
    nll = logz - gold
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def loss_and_grads(model: Model, params, batch):
    """(loss, gradients): ``loss_fn`` on ``batch`` (tensors on the
    parameters' device) and its gradient for every leaf, in
    ``tree_leaves`` order. The leaves are differentiated through detached
    aliases, so ``params`` keep their ``requires_grad`` flags."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(model, tree_unflatten(params, leaves), batch["tokens"],
                   batch["labels"], batch.get("mm_embeds"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads)


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    device="cuda"):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), with ``params`` and the optimizer state updated in place.

    ``batch`` = {"tokens": (B,S), "labels": (B,S)} (+ "mm_embeds" for
    multimodal configs), numpy arrays or tensors, moved to ``device``
    (``cuda`` unless the caller asks for the CPU; raises without a card).
    ``metrics``: the loss and the gradient norm as 0-d tensors, the
    learning rate of the step as a float."""
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(model, params, b)
        lr = cosine_lr(opt_state.step, peak=peak_lr, warmup=warmup,
                       total=total_steps)
        params, opt_state, gnorm = adamw_update(
            params, tree_unflatten(params, grads), opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
