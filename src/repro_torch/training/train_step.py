"""Causal-LM training step (the train_4k workload shape).

The port of ``repro/training/train_step.py``: the loss is logsumexp - gold
in float32 over ``labels >= 0``; gradients come from
``torch.autograd.grad`` over the parameter leaves in JAX's leaf order; the
update is the in-place AdamW of ``repro_torch.training.optimizer``. Where
a mesh shards the vocab, both terms of the loss run on each rank's vocab
shard (``_logz``, ``_gold``), so no rank holds the whole (B,S,V).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.ops import as_placements
from repro_torch.models.common import resolve_device
from repro_torch.models.hooks import constrain
from repro_torch.models.model import Model
from repro_torch.params import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import adamw_update, cosine_lr


def _vocab_layout(logits):
    """The mesh of a DTensor of logits (B,S,V), the mesh dims that shard V
    and the layout the loss's local functions take: batch and vocab
    shards kept, anything else gathered."""
    mesh = logits.device_mesh
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if p == Shard(2) and mesh.size(i) > 1]
    l_pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in logits.placements)
    return mesh, vocab_dims, l_pl


def _logz(logits):
    """logsumexp of ``logits`` (B,S,V) over V. Where a mesh shards V, each
    rank takes the logsumexp of its shard through ``local_map`` and the
    (B,S, vocab ranks) of them are reduced the same way; the plain call
    would gather the whole V on every rank first."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    mesh, vocab_dims, l_pl = _vocab_layout(logits)
    if not vocab_dims:
        return torch.logsumexp(logits, dim=-1)
    fn = local_map(lambda lg: torch.logsumexp(lg, dim=-1, keepdim=True),
                   out_placements=list(l_pl), in_placements=(l_pl,), device_mesh=mesh)
    return torch.logsumexp(fn(as_placements(logits, mesh, l_pl)), dim=-1)


def _gold(logits, idx):
    """``logits`` (B,S,V) at ``idx`` (B,S) along V. On a DTensor through
    ``local_map``: each rank takes the labels that fall in its vocab shard
    (zero for the rest), a partial sum over the vocab ranks, so that the
    gradient stays on the logits' own shards; the plain gather's backward
    would build zeros of the whole (B,S,V) on every rank."""
    if not isinstance(logits, DTensor):
        return torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
    mesh, vocab_dims, l_pl = _vocab_layout(logits)
    i_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in l_pl)
    o_pl = tuple(Partial() if i in vocab_dims else p for i, p in enumerate(i_pl))

    def local(lg, ix):
        if not vocab_dims:
            return torch.take_along_dim(lg, ix[..., None], dim=-1)[..., 0]
        start = 0
        for i in vocab_dims:
            start = start * mesh.size(i) + mesh.get_local_rank(i)
        ix = ix - start * lg.shape[-1]
        inside = (ix >= 0) & (ix < lg.shape[-1])
        g = torch.take_along_dim(lg, torch.where(inside, ix, 0)[..., None], dim=-1)[..., 0]
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))
    fn = local_map(local, out_placements=list(o_pl), in_placements=(l_pl, i_pl),
                   device_mesh=mesh)
    return fn(as_placements(logits, mesh, l_pl), as_placements(idx, mesh, i_pl))


def loss_fn(model: Model, params, tokens, labels, mm_embeds=None):
    """Mean next-token negative log-likelihood over ``labels >= 0``."""
    logits = model.forward_train(params, tokens, mm_embeds=mm_embeds).float()
    logz = _logz(logits)
    mask = labels >= 0
    # under a mesh the gold logits, taken from vocab shards, are summed
    # over the vocab ranks here
    gold = constrain(_gold(logits, torch.where(mask, labels, 0).long()), ("batch", None))
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
    # under a mesh the loss is a sum pending over the batch ranks: the value
    # returned is summed there (the gradient already flowed from the pending sum)
    return constrain(loss.detach(), ()), list(grads)


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    device="cuda", update=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), with ``params`` and the optimizer state updated in place.

    ``batch`` = {"tokens": (B,S), "labels": (B,S)} (+ "mm_embeds" for
    multimodal configs), numpy arrays or tensors, moved to ``device``
    (``cuda`` unless the caller asks for the CPU; raises without a card);
    DTensors (a batch distributed over a mesh, with the parameters and the
    optimizer state) are taken as they are.
    ``metrics``: the loss and the gradient norm as 0-d tensors, the
    learning rate of the step as a float. ``update`` stands in for the
    optimizer's step, ``adamw_update`` (the dry run passes it wrapped, to
    count the optimizer apart)."""
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        b = {k: v if isinstance(v, DTensor) else torch.as_tensor(v).to(dev)
             for k, v in batch.items()}
        loss, grads = loss_and_grads(model, params, b)
        lr = cosine_lr(opt_state.step, peak=peak_lr, warmup=warmup,
                       total=total_steps)
        params, opt_state, gnorm = (update or adamw_update)(
            params, tree_unflatten(params, grads), opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
