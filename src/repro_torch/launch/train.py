"""Training CLI of the PyTorch port (the train_4k substrate, reduced
configs).

The flags of ``python -m repro.launch.train`` plus ``--device``: the model
trains on the card unless ``--device cpu`` asks for the CPU (the scans'
plain versions and their plain backwards). The same stdout lines, and the
same ``--save`` file (``repro_torch.training.checkpoint``, readable by the
JAX package's ``restore`` in float32):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 \\
      --batch 2 --seq 32 --save ck
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.training import adamw_init, make_train_step
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import TokenStream


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--save", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw_init(params)
    step = make_train_step(model, total_steps=args.steps, device=dev)
    stream = TokenStream(cfg.vocab_size, seed=args.seed)
    mm_dim = cfg.mm_embed_dim if cfg.multimodal else None

    t0 = time.time()
    for i, batch in enumerate(stream.batches(args.batch, args.seq, mm_dim)):
        params, opt, metrics = step(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{(time.time() - t0):.1f}s", flush=True)
        if i + 1 >= args.steps:
            break
    if args.save:
        ckpt.save(args.save, params, step=args.steps)
        print(f"saved checkpoint to {args.save}.npz")


if __name__ == "__main__":
    main()
