"""Model facade: configuration, dtype, parameter init, one-token decode and
the recurrent-state cache.

Ported from ``repro/models/model.py``: ``init``, ``_embed``, ``_logits``,
``decode_step``, and ``make_cache`` / ``cache_bytes`` for "ssm" layers. The
serving engine runs attention stacks through ``TorchPagedRunner`` and SSM
stacks through ``StateRunner`` (which calls ``decode_step``). Not ported
yet: ``forward_train``, ``prefill``, ``pad_cache``, the multimodal
projection, and the dense caches of "attn", "moe" and "rglru" layers.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (dtype_of, embed_init, resolve_device,
                                       rms_norm, rope_angles)
from repro_torch.models.ssm import ssm_dims
from repro_torch.params import tree_leaves


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

    # ------------------------------------------------------------- helpers
    def _embed(self, params, tokens):
        return params["embed"][tokens.long()]

    def _logits(self, params, h):
        h = rms_norm(h, params["final_ln"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return h @ w

    def _rope(self, positions):
        cfg = self.cfg
        if cfg.num_heads == 0:          # pure SSM: no rope
            return (None, None)
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.mrope_sections)

    # ------------------------------------------------------------- modes
    def decode_step(self, params, tokens, caches, pos):
        """tokens (B,) int, pos (B,) int -> (logits (B,V), new caches). The
        caches given are not written: the new ones are new tensors."""
        b = tokens.shape[0]
        if self.cfg.mrope_sections:
            positions = pos[None, :, None].expand(3, b, 1)
        else:
            positions = pos[:, None]
        rope = self._rope(positions)
        h = self._embed(params, tokens[:, None])
        h, caches = tfm.stack_decode(params["layers"], self.cfg, h, rope, caches, pos)
        return self._logits(params, h)[:, 0], caches

    # ------------------------------------------------------------- caches
    def _cache_entry(self, kind, batch, total_len, make):
        cfg = self.cfg
        if kind == "ssm":
            d_inner, nheads = ssm_dims(cfg)
            conv_ch = d_inner + 2 * cfg.ssm_state
            return {"conv": make((batch, cfg.ssm_conv, conv_ch), self.dtype),
                    "ssd": make((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                                torch.float32)}
        if kind in ("attn", "moe", "rglru"):
            raise NotImplementedError(
                f"the dense cache of {kind!r} layers is not ported yet (the "
                "hybrid RG-LRU family is the next slice of the port)")
        raise ValueError(kind)

    def make_cache(self, batch, total_len, as_specs=False, device="cuda"):
        """Cache tree matching the segment structure: scan segments stack
        their entries on a leading layer axis. Zeros on ``device``, or with
        ``as_specs`` tensors on the ``meta`` device, which carry shape and
        dtype and allocate nothing."""
        dev = torch.device("meta") if as_specs else resolve_device(device)
        caches = []
        for stype, unit, n in tfm.segments(self.cfg):
            lead = (n,) if stype == "scan" else ()

            def make(shape, dtype, lead=lead):
                return torch.zeros(lead + shape, dtype=dtype, device=dev)
            caches.append(tuple(self._cache_entry(k, batch, total_len, make)
                                for k in unit))
        return caches

    def cache_bytes(self, batch, total_len) -> int:
        specs = self.make_cache(batch, total_len, as_specs=True)
        return sum(t.numel() * t.element_size() for t in tree_leaves(specs))
