"""Model facade: configuration, dtype and parameter init.

The dense-cache modes of ``repro/models/model.py`` (``prefill``,
``decode_step``, ``make_cache``, ``pad_cache``) are not ported yet; the
serving engine runs the model through ``TorchPagedRunner``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import dtype_of, embed_init


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = dtype_of(cfg)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator):
        """Parameters with the layout and distributions of the JAX init,
        drawn from ``generator`` on its own device. The draws differ from
        ``jax.random``'s: parity tests carry JAX weights over with
        ``repro_torch.params.from_jax`` instead."""
        cfg = self.cfg
        if cfg.multimodal:
            raise NotImplementedError("the multimodal projection is not ported yet")
        params = {
            "embed": embed_init(generator, (cfg.vocab_size, cfg.d_model), self.dtype),
            "final_ln": torch.ones((cfg.d_model,), dtype=self.dtype,
                                   device=generator.device),
            "layers": tfm.stack_init(generator, cfg, self.dtype),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(generator, (cfg.d_model, cfg.vocab_size),
                                           self.dtype)
        return params
