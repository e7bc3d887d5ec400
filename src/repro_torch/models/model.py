"""Model facade: configuration, dtype, parameter init, the dense prefill /
decode path and its caches.

Ported from ``repro/models/model.py``: ``init``, ``_embed``, ``_logits``,
``forward_train``, ``prefill``, ``decode_step``, and ``make_cache`` /
``pad_cache`` / ``cache_bytes`` for "attn" and "moe" (the ring of
``attn_cache_len`` slots), "ssm" and "rglru" layers. The serving engine runs attention stacks
(dense and MoE) through ``TorchPagedRunner`` and state stacks (SSM and the
hybrid RG-LRU family) through ``StateRunner``, which calls
``decode_step``. The multimodal configs carry ``mm_proj``: ``prefill``
writes the projected conditioning embeddings over the leading token
embeddings, as the JAX model does. ``forward_train`` is the training
forward (``repro_torch.training``): the stack under checkpointing, every
position's logits.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (default_positions, dtype_of, embed_init,
                                       resolve_device, rms_norm, rope_angles)
from repro_torch.models.rglru import rglru_width
from repro_torch.models.ssm import ssm_dims
from repro_torch.params import tree_leaves, tree_map

LONG_THRESHOLD = 1 << 18  # >= 256k context => sliding-window policy kicks in


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = dtype_of(cfg)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator):
        """Parameters with the layout and distributions of the JAX init,
        drawn from ``generator`` on its own device. The draws differ from
        ``jax.random``'s: parity tests carry JAX weights over with
        ``repro_torch.params.from_jax`` instead. Stacked weights are drawn
        one layer at a time (``dense_init``), so the peak is the weights
        plus one layer's float32 slice."""
        cfg = self.cfg
        params = {
            "embed": embed_init(generator, (cfg.vocab_size, cfg.d_model), self.dtype),
            "final_ln": torch.ones((cfg.d_model,), dtype=self.dtype,
                                   device=generator.device),
            "layers": tfm.stack_init(generator, cfg, self.dtype),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(generator, (cfg.d_model, cfg.vocab_size),
                                           self.dtype)
        if cfg.multimodal:
            params["mm_proj"] = embed_init(generator, (cfg.mm_embed_dim, cfg.d_model),
                                           self.dtype)
        return params

    # ------------------------------------------------------------- helpers
    def _embed(self, params, tokens, mm_embeds=None):
        h = params["embed"][tokens.long()]
        if mm_embeds is not None and self.cfg.multimodal:
            # JAX's dynamic_update_slice at (0, 0, 0): the projected frames
            # replace the first rows and positions of the embeddings
            fused = mm_embeds.to(self.dtype) @ params["mm_proj"]
            bm, length = fused.shape[:2]
            if bm > h.shape[0] or length > h.shape[1]:
                raise ValueError(f"conditioning frames {tuple(fused.shape[:2])} do "
                                 f"not fit the tokens {tuple(h.shape[:2])}")
            h[:bm, :length] = fused          # a gathered copy: the table is untouched
        return h

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

    def _positions(self, batch, seq, positions, device="cpu"):
        if positions is not None:
            return positions
        return default_positions(batch, seq, mrope=bool(self.cfg.mrope_sections),
                                 device=device)

    # ------------------------------------------------------------- modes
    def forward_train(self, params, tokens, mm_embeds=None, positions=None):
        """tokens (B,S) -> logits (B,S,V)."""
        b, s = tokens.shape
        rope = self._rope(self._positions(b, s, positions, device=tokens.device))
        h = self._embed(params, tokens, mm_embeds)
        h, _ = tfm.stack_context(params["layers"], self.cfg, h, rope, train=True)
        return self._logits(params, h)

    def prefill(self, params, tokens, mm_embeds=None, seq_lens=None, positions=None):
        """tokens (B,S) -> (last_logits (B,V), cache). ``mm_embeds``
        (Bm,L,mm_embed_dim) of a multimodal config replace the embeddings of
        the first Bm rows' first L positions after projection. ``seq_lens``
        (B,) masks right padding and picks each row's last real position."""
        b, s = tokens.shape
        rope = self._rope(self._positions(b, s, positions, device=tokens.device))
        h = self._embed(params, tokens, mm_embeds)
        h, caches = tfm.stack_context(params["layers"], self.cfg, h, rope,
                                      seq_lens=seq_lens, return_cache=True)
        if seq_lens is not None:
            idx = torch.clamp(seq_lens.long() - 1, min=0)
            h_last = torch.take_along_dim(h, idx[:, None, None], dim=1)[:, 0]
        else:
            h_last = h[:, -1]
        logits = self._logits(params, h_last[:, None])[:, 0]
        return logits, caches

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
    def attn_cache_len(self, total_len: int) -> int:
        cfg = self.cfg
        if cfg.block_pattern:                       # hybrid local attention
            return min(total_len, cfg.window)
        if cfg.long_context == "sliding_window" and total_len >= LONG_THRESHOLD:
            return min(total_len, cfg.sliding_window)
        return total_len

    def _cache_entry(self, kind, batch, total_len, make):
        cfg = self.cfg
        dt = self.dtype
        if kind in ("attn", "moe"):
            s = self.attn_cache_len(total_len)
            shp = (batch, s, cfg.num_kv_heads, cfg.head_dim)
            return {"k": make(shp, dt), "v": make(shp, dt)}
        if kind == "ssm":
            d_inner, nheads = ssm_dims(cfg)
            conv_ch = d_inner + 2 * cfg.ssm_state
            return {"conv": make((batch, cfg.ssm_conv, conv_ch), dt),
                    "ssd": make((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                                torch.float32)}
        if kind == "rglru":
            w = rglru_width(cfg)
            return {"conv": make((batch, cfg.ssm_conv, w), dt),
                    "h": make((batch, w), torch.float32)}
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

    def pad_cache(self, caches, prefill_len, total_len):
        """Convert a prefill cache (seq len = prefill_len) into a decode cache
        sized for ``total_len`` positions, preserving ring-slot semantics.
        Attention entries are new tensors; the others pass through."""
        target = self.attn_cache_len(total_len)

        def remap(arr):
            s_p = arr.shape[-3]
            if s_p <= target:
                return torch.nn.functional.pad(arr, (0, 0, 0, 0, 0, target - s_p))
            # window ring: keep last `target` keys at slots pos % target
            positions = torch.arange(s_p - target, s_p, device=arr.device)
            out = arr.new_zeros(arr.shape[:-3] + (target,) + arr.shape[-2:])
            out[..., positions % target, :, :] = arr[..., positions, :, :]
            return out

        out = []
        for (stype, unit, n), seg in zip(tfm.segments(self.cfg), caches):
            out.append(tuple(tree_map(remap, e) if k in ("attn", "moe") else e
                             for e, k in zip(seg, unit)))
        return out

    def cache_bytes(self, batch, total_len) -> int:
        specs = self.make_cache(batch, total_len, as_specs=True)
        return sum(t.numel() * t.element_size() for t in tree_leaves(specs))
