#!/usr/bin/env python3
"""Where the port's first AdamW step strays from the JAX package's.

Takes one step of both packages' train steps on the CPU, as
``tests/test_torch_training.py`` does (the reduced config, the same JAX
init carried by ``params.from_jax``, ``TokenStream`` seed 0, B 2, S 32, the
default schedule), and prints every entry whose step differs from JAX's by
more than 0.1 lr: the leaf, the index, the gap in lr, both packages'
float32 gradients clipped as the step clips them, AdamW's eps, the leaf's
largest gradient, and the same entry's gradient from the port's model run
in float64 (every ``Tensor.float()`` of the port widened to float64).

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/step_gap.py musicgen-medium
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/step_gap.py recurrentgemma-9b --layers 5
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.training import adamw_init as jadamw_init
from repro.training import loss_fn as jloss_fn
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.params import from_jax, tree_leaves, tree_map
from repro_torch.training import adamw_init, make_train_step
from repro_torch.training.data import TokenStream
from repro_torch.training.train_step import loss_and_grads

EPS, STEP_LR = 1e-8, 0.1


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


def _float64_grads(model, params, batch):
    """The port's gradients with its model computing in float64."""
    widen = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    dtype, model.dtype = model.dtype, torch.float64
    try:
        b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        loss, grads = loss_and_grads(model, tree_map(lambda t: t.double(), params), b64)
    finally:
        torch.Tensor.float, model.dtype = widen, dtype
    assert all(g.dtype == torch.float64 for g in grads)
    return float(loss), grads


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=None, help="cut the reduced config's depth")
    args = ap.parse_args()
    torch.manual_seed(0)
    jcfg = jget_config(args.arch).reduced()
    if args.layers:
        jcfg = dataclasses.replace(jcfg, num_layers=args.layers)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    p = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    mm = jcfg.mm_embed_dim if jcfg.multimodal else None
    batch = next(TokenStream(jcfg.vocab_size, seed=0).batches(2, 32, mm))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jloss_fn(
        jm, q, jb["tokens"], jb["labels"], jb.get("mm_embeds"))))(jp)
    loss, grads = loss_and_grads(m, p, tb)
    loss64, grads64 = _float64_grads(m, p, tb)
    old, jold = [t.clone() for t in tree_leaves(p)], jax.tree.leaves(jp)
    jp2, _, jmet = jax.jit(jmake_train_step(jm))(jp, jadamw_init(jp), jb)
    p2, _, met = make_train_step(m, device="cpu")(p, adamw_init(p), batch)
    lr, gnorm = met["lr"], float(jmet["grad_norm"])
    scale = min(1.0, 1.0 / (gnorm + 1e-9))
    print(f"{args.arch} reduced, {jcfg.num_layers} layers: loss port {float(loss):.7f} "
          f"JAX {float(jloss):.7f} float64 {loss64:.7f}; gradient norm port "
          f"{float(met['grad_norm']):.6f} JAX {gnorm:.6f}; lr {lr:.3e}; clip scale "
          f"{scale:.6f}; eps {EPS:g}")
    found = 0
    for path, a0, a1, b0, b1, g, jg, g64 in zip(
            _paths(p), old, tree_leaves(p2), jold, jax.tree.leaves(jp2), grads,
            jax.tree.leaves(jgrads), grads64):
        gap = ((a1 - a0).double().numpy()
               - (np.asarray(b1, np.float64) - np.asarray(b0, np.float64))) / lr
        g, jg, g64 = g.double().numpy(), np.asarray(jg, np.float64), g64.numpy()
        for i in zip(*np.nonzero(np.abs(gap) > STEP_LR)):
            found += 1
            print(f"  {path}{list(map(int, i))}: step gap {abs(gap[i]):.4f} lr; clipped "
                  f"gradient port {g[i] * scale:.3e} JAX {jg[i] * scale:.3e} float64 "
                  f"{g64[i] * scale:.3e}; leaf's largest |gradient| {np.abs(jg).max():.3e}; "
                  f"leaf's float32 roundoff (port vs float64, JAX vs float64, largest) "
                  f"{np.abs(g - g64).max():.3e}, {np.abs(jg - g64).max():.3e}")
    print(f"{found} entries over {STEP_LR} lr")


if __name__ == "__main__":
    main()
