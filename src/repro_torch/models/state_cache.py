"""State-snapshot serving path for recurrent-state models: pure SSM
(mamba2) and the hybrid RG-LRU family (recurrentgemma).

The port of ``repro/models/state_cache.py``. Echo's prefix caching adapted
to recurrent state: instead of paged KV, the cache pool stores the
recurrent state snapshot *after every block_size tokens* (for pure SSM
block_size == cfg.ssm_chunk, so SSD chunk boundaries line up with
BlockManager blocks). A prefix hit resumes from the snapshot of the last
cached block; eviction priorities / threshold / RC apply to snapshot slots
exactly as to KV blocks — the BlockManager is unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.block_io import io_spec_for_model
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device, rms_norm
from repro_torch.models.model import Model
from repro_torch.models.ssm import ssm_context
from repro_torch.params import tree_map


def _host(tree):
    return tree_map(lambda t: t.to("cpu"), tree)


class StateRunner:
    """Engine runner for recurrent-state configs: pure SSM (mamba2) and
    hybrid (recurrentgemma — RG-LRU states + *bounded* local-attention
    window rings of ``max(cfg.window, 1)`` slots; the full snapshot stays
    fixed-size, so block-boundary snapshotting works identically). The
    snapshot pool is a host-side dict bid -> state tree, of CPU tensors
    except the entries a swap-in restored on the device (slots are
    overwritten when the BlockManager reuses a block id, so stale entries
    are harmless); the live states, one per running request, stay on the
    runner's device.

    Pure SSM: a prefill chunk's whole blocks run through the span function:
    every layer's SSD chunk scan (the CUDA kernel on the card) from the
    resumed state, with the state captured at each block boundary. The
    chunk's ragged tail and decode step one request at a time through
    ``Model.decode_step``, as the JAX runner does. Hybrid: as in JAX, no
    span function; every prefill and decode token steps through
    ``Model.decode_step``, with a snapshot at each block boundary.

    State updates are functional, as in JAX: every step builds new state
    tensors and nothing writes into a state in place. So a live state, a
    pool entry and a host-tier payload may share tensors (on the CPU,
    ``t.to("cpu")`` returns ``t`` itself) without a later step reaching a
    stored snapshot."""

    def __init__(self, model: Model, params, num_blocks: int, block_size: int,
                 max_pages_per_seq: int, chunk_size: int, device="cuda"):
        cfg = model.cfg
        kinds = set(cfg.attn_layers)
        if not kinds <= {"ssm", "rglru", "attn"}:
            raise NotImplementedError("StateRunner: ssm/hybrid families only")
        self._pure_ssm = kinds == {"ssm"}
        if self._pure_ssm and block_size != cfg.ssm_chunk:
            raise ValueError("block_size must equal ssm_chunk so snapshots "
                             "align with blocks")
        if chunk_size % block_size:
            raise ValueError("chunk_size must be a multiple of block_size")
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.block_size = block_size
        # hybrid: the attention ring must cover the local window
        self._state_len = 1 if self._pure_ssm else max(cfg.window, 1)
        self.io = io_spec_for_model(model)   # state: fixed-size snapshots
        self.pool: Dict[int, object] = {}       # bid -> state tree
        self.live: Dict[int, object] = {}       # rid -> state tree (device)
        # position the live state is valid for: a preempted request can be
        # re-admitted with a LONGER cached prefix than it had computed (the
        # pool gained boundaries meanwhile), making the surviving live
        # state stale for the new resume point — it must only short-circuit
        # the boundary-snapshot resume when the positions agree
        self._live_pos: Dict[int, int] = {}     # rid -> tokens consumed
        self.span_calls = 0
        if self._pure_ssm:
            # per-layer views of the stacked weights for the span: a
            # pure-SSM config is one scan segment of ssm blocks
            (blocks,) = self.params["layers"][0]
            self._layers = [tree_map(lambda a, i=i: a[i], blocks)
                            for i in range(cfg.num_layers)]

    # ------------------------------------------------------------- states
    def _zeros_state(self):
        return self.model.make_cache(1, self._state_len, device=self.device)

    def _span(self, tokens: Sequence[int], state):
        """Consume ``len(tokens)`` (block-aligned) tokens from ``state``.
        Returns (last logits (V,), final state, boundaries: one state tree
        per block, each the state after that block)."""
        self.span_calls += 1
        cfg = self.model.cfg
        nb = len(tokens) // self.block_size
        toks = torch.tensor(list(tokens), dtype=torch.long, device=self.device)
        h = self.params["embed"][toks][None]                   # (1,n,d)
        (st,) = state[0]
        caches, bounds = [], []
        for i, p in enumerate(self._layers):
            out, cache, bnd = ssm_context(
                p["ssm"], cfg, rms_norm(h, p["ln"], cfg.norm_eps),
                return_cache=True,
                initial={"conv": st["conv"][i], "ssd": st["ssd"][i]},
                boundary_states=True)
            h = h + out
            caches.append(cache)
            bounds.append(bnd)
        logits = self.model._logits(self.params, h[:, -1])[0]
        new_state = [(tfm.stack_layers(caches),)]
        conv_dtype = caches[0]["conv"].dtype
        boundaries = [
            [({"conv": torch.stack([b["conv"][:, j] for b in bounds]).to(conv_dtype),
               "ssd": torch.stack([b["ssd"][:, j] for b in bounds])},)]
            for j in range(nb)]
        return logits, new_state, boundaries

    def _step(self, token: int, state, pos: int):
        """One token through ``Model.decode_step``: (logits (V,), state)."""
        lg, state = self.model.decode_step(
            self.params, torch.tensor([token], device=self.device), state,
            torch.tensor([pos], device=self.device))
        return lg[0], state

    # ------------------------------------------------------------- API
    @torch.inference_mode()
    def prefill_chunk(self, token_chunk: Sequence[int], ctx_len: int,
                      block_table: Sequence[int],
                      rid: Optional[int] = None) -> np.ndarray:
        bs = self.block_size
        assert ctx_len % bs == 0, "resume points are block-aligned"
        if rid in self.live and self._live_pos.get(rid) == ctx_len:
            state = self.live[rid]
        elif ctx_len > 0 and block_table[ctx_len // bs - 1] in self.pool:
            state = tree_map(lambda t: t.to(self.device),
                             self.pool[block_table[ctx_len // bs - 1]])
        else:
            assert ctx_len == 0, "resume snapshot missing"
            state = self._zeros_state()

        toks = list(token_chunk)
        full = (len(toks) // bs * bs) if self._pure_ssm else 0
        logits = None
        if full:
            logits, state, boundaries = self._span(toks[:full], state)
            first_block = ctx_len // bs
            for i, bstate in enumerate(boundaries):
                self.pool[block_table[first_block + i]] = _host(bstate)
        for j, t in enumerate(toks[full:]):
            p = ctx_len + full + j
            logits, state = self._step(t, state, p)
            if (p + 1) % bs == 0 and (p + 1) // bs - 1 < len(block_table):
                self.pool[block_table[(p + 1) // bs - 1]] = _host(state)
        self.live[rid] = state
        self._live_pos[rid] = ctx_len + len(toks)
        return logits.float().cpu().numpy()

    @torch.inference_mode()
    def decode(self, tokens: Sequence[int], block_tables: List[Sequence[int]],
               pos: Sequence[int],
               rids: Optional[Sequence[int]] = None) -> np.ndarray:
        bs = self.block_size
        out = np.zeros((len(tokens), self.model.cfg.vocab_size), np.float32)
        for i, (t, bt, p, rid) in enumerate(zip(tokens, block_tables, pos, rids)):
            state = self.live.get(rid)
            if state is None:
                state = self._zeros_state()
            lg, state = self._step(t, state, p)
            self.live[rid] = state
            self._live_pos[rid] = p + 1
            if (p + 1) % bs == 0 and (p + 1) // bs - 1 < len(bt):
                self.pool[bt[(p + 1) // bs - 1]] = _host(state)
            out[i] = lg.float().cpu().numpy()
        return out

    def release(self, rid: int) -> None:
        self.live.pop(rid, None)
        self._live_pos.pop(rid, None)

    # --------------------------------------------------- host tier protocol
    # Same split-phase block I/O protocol as TorchPagedRunner, over boundary
    # snapshots instead of KV pages. The pool already lives host-side and
    # its entries are never written in place, so snapshot/materialize are
    # reference hand-offs, not copies — the copy stream's worker can hold
    # them race-free while the owner thread keeps dispatching compute.
    def snapshot_block(self, bid: int):
        """Phase 1 of a device->host block read: hand out the boundary
        snapshot recorded for ``bid``. Every committed block has one — the
        span function and decode store a snapshot at each crossed boundary,
        and swap-in re-registers restored payloads."""
        snap = self.pool.get(bid)
        assert snap is not None, f"no boundary snapshot for block {bid}"
        return snap

    @staticmethod
    def materialize(snapshot):
        """Phase 2: ensure the snapshot is host-resident. Pool entries
        already are (a no-op tree pass); entries staged device-side by a
        recent ``write_block`` get pulled across here."""
        return _host(snapshot)

    def read_block(self, bid: int):
        """Synchronous device->host staging of one boundary snapshot."""
        return self.materialize(self.snapshot_block(bid))

    def stage_payload(self, payload):
        """Host->device upload of one snapshot (the H2D half of swap-in) —
        safe on the copy worker; the pool insert stays with the owner."""
        return tree_map(lambda t: t.to(self.device), payload)

    def write_block(self, bid: int, payload) -> None:
        """Restore one boundary snapshot device-side: upload (no-op if the
        copy worker already staged it) and re-register under ``bid``. The
        next ``prefill_chunk`` resume from this boundary pays no H2D copy."""
        self.pool[bid] = self.stage_payload(payload)

    def write_block_lazy(self, bid: int, payload) -> None:
        """Re-register a host payload under ``bid`` WITHOUT uploading — the
        ``"in_lazy"`` half of restore_last_only swap-in: earlier boundaries
        of a restored prefix only matter for future mid-prefix resumes, and
        resume uploads whatever the pool holds."""
        self.pool[bid] = payload

    def bytes_per_block(self, n_tokens: int) -> int:
        """Link weight of one block: the fixed-size snapshot, regardless of
        how deep the boundary sits in the prefix."""
        return self.io.block_bytes(n_tokens)
