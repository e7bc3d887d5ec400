#!/usr/bin/env python3
"""How far float32 roundoff in the SSD scan moves bf16 mamba2-1.3b's first
training step, in the port on the card and in the JAX package on the CPU.

mamba2-1.3b at full width (bf16) is cut to each DEPTH given; one batch of
``TokenStream`` seed 0 at B 1, S 4096 (``--seq``) goes through
``loss_and_grads`` (the first step's loss and gradients). For each pair of
runs it prints the relative gaps of the loss and of the gradient norm, and
the largest relative gap (in norm) of a leaf's gradient.

On the card (the default), with seeded random weights as ``chip_smoke.py``
phase 25 makes them, three runs: through the scan kernels (chunk 64);
through autograd of the plain scans on the card (chunk 64), the comparison
that phase 25 holds to 1e-3; and through the plain scans with chunk 32, the
same function with another order of float32 sums:

    python3 tools/bf16_spread.py 4 16 32 48

With ``--jax``, the JAX package on the CPU, with its own init
(``PRNGKey(0)``): ``ssd_chunked`` with chunk 64 against chunk 32, the same
comparison in the reference (slow: a full-width step on the CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_spread.py --jax 4 16

With ``--same-weights``, both packages on the CPU on the same weights (the
JAX init, ``PRNGKey(0)``, carried by ``params.from_jax``), each in bf16
and on a float32 copy: the bf16 steps' gaps from the float32 step and from
each other, and each leaf's relative gap from JAX's float32 gradient:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_spread.py --same-weights 8
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _gaps(a, b, norm=np.linalg.norm):
    """Relative gaps of (loss, gradient norm, leaves) b against a."""
    (la, na, ga), (lb, nb, gb) = a, b
    leaf = max(float(norm(x - y) / max(float(norm(x)), 1e-30)) for x, y in zip(ga, gb))
    return abs(lb - la) / abs(la), abs(nb - na) / abs(na), leaf


def card_runs(depth, seq):
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training.data import TokenStream
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import loss_and_grads

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=depth)
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    batch = next(TokenStream(cfg.vocab_size, seed=0).batches(1, seq))
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    runs = {}
    for name, chunk, plain in (("kernel", 64, False), ("plain", 64, True),
                               ("plain chunk 32", 32, True)):
        model = Model(dataclasses.replace(cfg, ssm_chunk=chunk))
        with cs._PlainScans() if plain else contextlib.nullcontext():
            loss, grads = loss_and_grads(model, params, batch)
            runs[name] = (float(loss), float(global_norm(grads)),
                          [g.float() for g in grads])
        del loss, grads

    def norm(t):
        return torch.linalg.vector_norm(t.double())
    return [("kernel vs plain", _gaps(runs["plain"], runs["kernel"], norm)),
            ("plain chunk 32 vs 64", _gaps(runs["plain"], runs["plain chunk 32"], norm))]


def jax_runs(depth, seq):
    import jax

    from repro.configs import get_config
    from repro.models import Model
    from repro.training import loss_fn
    from repro.training.data import TokenStream
    from repro.training.optimizer import global_norm

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=depth)
    params = Model(cfg).init(jax.random.PRNGKey(0))
    batch = next(TokenStream(cfg.vocab_size, seed=0).batches(1, seq))
    runs = []
    for chunk in (64, 32):
        jm = Model(dataclasses.replace(cfg, ssm_chunk=chunk))
        loss, grads = jax.jit(jax.value_and_grad(lambda q: loss_fn(
            jm, q, batch["tokens"], batch["labels"])))(params)
        runs.append((float(loss), float(global_norm(grads)),
                     [np.asarray(g, np.float64) for g in jax.tree.leaves(grads)]))
        del grads
    return [("JAX chunk 32 vs 64", _gaps(*runs))]


def same_weights_runs(depth, seq):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config
    from repro.models import Model as JModel
    from repro.training import loss_fn
    from repro.training.data import TokenStream
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    from repro_torch.params import from_jax
    from repro_torch.training.train_step import loss_and_grads

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=depth)
    init = JModel(cfg).init(jax.random.PRNGKey(0))
    batch = next(TokenStream(cfg.vocab_size, seed=0).batches(1, seq))
    runs = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        jm = JModel(c)
        q = init if dtype == "bfloat16" else jax.tree.map(lambda t: t.astype(jnp.float32), init)
        loss, grads = jax.jit(jax.value_and_grad(lambda q: loss_fn(
            jm, q, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]))))(q)
        leaves = [np.asarray(g, np.float64) for g in jax.tree.leaves(grads)]
        runs[f"JAX {dtype}"] = (float(loss), _norm(leaves), leaves)
        loss, grads = loss_and_grads(Model(ModelConfig(**dataclasses.asdict(c))),
                                     from_jax(jax.tree.map(np.asarray, q), "cpu"),
                                     {k: torch.from_numpy(v) for k, v in batch.items()})
        leaves = [g.double().numpy() for g in grads]
        runs[f"port {dtype}"] = (float(loss), _norm(leaves), leaves)
        del grads
    ref = runs["JAX float32"][2]
    for i, path in enumerate(_paths(init)):
        base = max(float(np.linalg.norm(ref[i])), 1e-30)
        gaps = ", ".join(f"{k} {np.linalg.norm(runs[k][2][i] - ref[i]) / base:.2e}"
                         for k in ("JAX bfloat16", "port bfloat16", "port float32"))
        print(f"  {path}: share of the squared norm {base ** 2 / runs['JAX float32'][1] ** 2:.4f}; "
              f"relative gap from JAX float32: {gaps}")
    return [("JAX bf16 vs JAX float32", _gaps(runs["JAX float32"], runs["JAX bfloat16"])),
            ("port bf16 vs port float32", _gaps(runs["port float32"], runs["port bfloat16"])),
            ("port bf16 vs JAX bf16", _gaps(runs["JAX bfloat16"], runs["port bfloat16"])),
            ("port float32 vs JAX float32", _gaps(runs["JAX float32"], runs["port float32"]))]


def _norm(leaves):
    return float(np.sqrt(sum(float((g ** 2).sum()) for g in leaves)))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("depths", type=int, nargs="+")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--jax", action="store_true", help="the JAX package on the CPU")
    ap.add_argument("--same-weights", action="store_true",
                    help="both packages on the CPU, bf16 and float32, on the same weights")
    args = ap.parse_args()
    runs = jax_runs if args.jax else same_weights_runs if args.same_weights else card_runs
    if runs is card_runs:
        import torch
        if not torch.cuda.is_available():
            sys.exit("bf16_spread: no CUDA device (use --jax for the reference on the CPU)")
        print(torch.cuda.get_device_name(0), flush=True)
    for d in args.depths:
        for what, (loss, gnorm, leaf) in runs(d, args.seq):
            print(f"depth {d:2d} {what}: loss {loss:.2e}, gradient norm {gnorm:.2e}, "
                  f"largest leaf {leaf:.2e} apart (relative)", flush=True)


if __name__ == "__main__":
    main()
