"""Paged-KV execution path for the serving engine (attention families).

KV lives in a global page pool per layer; requests reference pages through
block tables (the BlockManager owns the indirection). On the card the
attention inner loops are the CUDA kernels in ``repro_torch.kernels``; on
the CPU their plain PyTorch versions execute the same layout. Prefill is
chunked (Sarathi-style) and decode is batched — the two batch shapes
Echo's scheduler composes. The pool is updated in place: the counterpart
of the JAX runner's donated jit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.block_io import io_spec_for_model
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import _qkv
from repro_torch.models.common import resolve_device, rms_norm, rope_angles, swiglu
from repro_torch.models.model import Model
from repro_torch.params import tree_map


def _write_pages(pages, flat_idx, new):
    """pages (P,bs,H,hd), updated in place; flat_idx (N,) into P*bs. The
    caller passes only the live rows: torch has no dropping scatter like
    JAX's ``mode="drop"``, and an out-of-range index raises (or asserts on
    the device) instead of being skipped."""
    p, bs, h, hd = pages.shape
    pages.view(p * bs, h, hd).index_copy_(0, flat_idx, new)


def _flat_slots(block_tables, pos, bs):
    """Row of the flattened pool (P*bs) holding absolute position ``pos``
    through ``block_tables`` (..., nblk): shapes broadcast as in indexing."""
    return block_tables.long().gather(-1, pos // bs) * bs + pos % bs


def _attn_prefill_paged(p, cfg, x, cos, sin, k_pages, v_pages, write_idx,
                        gather_idx, ctx_len, impl="auto"):
    """x (1,Sc,d). Writes the chunk's live KV rows (``write_idx``, one per
    live row) into the pages, gathers the sequence's table rows
    (``gather_idx``, nblk*bs of them) and attends the chunk against them."""
    q, k, v = _qkv(p, cfg, x, cos, sin)                 # (1,Sc,H*,hd)
    n = write_idx.shape[0]
    _write_pages(k_pages, write_idx, k[0, :n])
    _write_pages(v_pages, write_idx, v[0, :n])
    _, _, h, hd = k_pages.shape
    kk = k_pages.view(-1, h, hd)[gather_idx]
    vv = v_pages.view(-1, h, hd)[gather_idx]
    out = kops.chunked_prefill_attention(q[0].contiguous(), kk, vv, ctx_len,
                                         impl=impl)
    return torch.einsum("shk,hkd->sd", out, p["wo"])[None]


def _attn_decode_paged(p, cfg, x, cos, sin, k_pages, v_pages, block_tables,
                       ctx_lens, write_idx, impl="auto"):
    """x (B,1,d); block_tables (B,nblk) int32; ctx_lens (B,) int32, 0 on the
    padded rows. The live rows are the first ``len(write_idx)``; their new
    KV goes to ``write_idx``."""
    q, k, v = _qkv(p, cfg, x, cos, sin)
    n = write_idx.shape[0]
    _write_pages(k_pages, write_idx, k[:n, 0])
    _write_pages(v_pages, write_idx, v[:n, 0])
    out = kops.paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                               block_tables, ctx_lens, impl=impl)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]


class TorchPagedRunner:
    """Owns the page pool and runs paged prefill/decode through the
    attention kernels. The duck-typed API of ``repro``'s ``PagedRunner``:
    ``prefill_chunk`` / ``decode`` return numpy float32 logits, and the
    block I/O protocol moves host payloads ``[segment][unit]{"k","v"}`` of
    numpy ``(n_layers, page_size, Hkv, hd)`` arrays (bfloat16 pools carry
    their raw bits as ``uint16``)."""

    def __init__(self, model: Model, params, num_pages: int, page_size: int,
                 max_pages_per_seq: int, chunk_size: int,
                 attn_impl: str = "auto", device="cuda"):
        cfg = model.cfg
        kinds = set(cfg.attn_layers)
        if kinds != {"attn"}:
            raise NotImplementedError(
                f"the port's paged runner serves dense attention stacks, got "
                f"{sorted(kinds)}; MoE and the state families are not ported yet")
        self.device = resolve_device(device)
        kops.check_impl(attn_impl)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages = max_pages_per_seq
        self.chunk_size = chunk_size
        self.attn_impl = attn_impl
        self.io = io_spec_for_model(model)   # paged: per-token KV payload
        shp = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
        self.pages = []
        for stype, unit, n in tfm.segments(cfg):
            self.pages.append(tuple(
                {name: torch.zeros((n,) + shp, dtype=model.dtype,
                                   device=self.device) for name in ("k", "v")}
                for _ in unit))
        # per-layer views of the stacked weights and pages, in stack order
        self._layers = []
        for (stype, _, n), seg_p, seg_pg in zip(
                tfm.segments(cfg), self.params["layers"], self.pages):
            for i in range(n):
                for p_k, pg_k in zip(seg_p, seg_pg):
                    if stype == "scan":
                        p_k = tree_map(lambda a, i=i: a[i], p_k)
                        pg_k = {name: pg_k[name][i] for name in ("k", "v")}
                    else:
                        pg_k = {name: pg_k[name][0] for name in ("k", "v")}
                    self._layers.append((p_k, pg_k))

    # ------------------------------------------------------------- impls
    def _rope_for(self, positions):
        cfg = self.model.cfg
        if cfg.mrope_sections:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.mrope_sections)

    def _run_stack(self, h, rope, attn_fn):
        cfg = self.model.cfg
        cos, sin = rope
        for p, pg in self._layers:
            x = rms_norm(h, p["ln1"], cfg.norm_eps)
            h = h + attn_fn(p["attn"], cfg, x, cos, sin, pg["k"], pg["v"])
            h = h + swiglu(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))
        return h

    def _final_logits(self, h):
        cfg = self.model.cfg
        h = rms_norm(h, self.params["final_ln"], cfg.norm_eps)
        w = (self.params["embed"].T if cfg.tie_embeddings
             else self.params["unembed"])
        return h @ w

    def _to_device(self, a: np.ndarray):
        return torch.from_numpy(a).to(self.device)

    def release(self, rid: int) -> None:
        """No per-request device state beyond the pages (owned by the
        BlockManager); nothing to drop."""

    # ------------------------------------------------------- host KV swap
    def snapshot_block(self, bid: int):
        """Phase 1 of a device->host block read: copy the per-layer page
        slices on the pool owner's thread and stream. Stream order puts the
        copy before any later compute that overwrites the page, so the
        snapshot holds the pre-overwrite content."""
        return [tuple({name: pg[name][:, bid].clone() for name in ("k", "v")}
                      for pg in seg) for seg in self.pages]

    @staticmethod
    def materialize(snapshot):
        """Phase 2: wait for the snapshot's copies and bring them to host
        numpy. Reads only the snapshot's own buffers, so it is safe on the
        copy worker while the owner thread keeps launching compute."""
        def host(t):
            t = t.cpu()
            if t.dtype == torch.bfloat16:
                return t.view(torch.uint16).numpy()
            return t.numpy()
        return [tuple({name: host(blk[name]) for name in ("k", "v")}
                      for blk in seg) for seg in snapshot]

    def read_block(self, bid: int):
        """Device->host staging of one KV page across every layer: the
        swap-out half of the tiered cache (synchronous snapshot +
        materialize). Returns a nested [segment][unit]{"k","v"} structure of
        host numpy arrays, shape (n_layers, page_size, H, hd) each."""
        return self.materialize(self.snapshot_block(bid))

    def stage_payload(self, payload):
        """Host->device upload of a block payload (the H2D half of swap-in)
        without touching the page pool — safe on the copy worker. The
        in-place write into the pool (``write_block``) stays with the pool
        owner. Idempotent on already-staged device tensors."""
        def up(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device)
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:          # e.g. a payload from JAX
                a = a.copy()
            t = torch.from_numpy(a)
            if t.dtype == torch.uint16 and self.model.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            return t.to(self.device)
        return tree_map(up, payload)

    def write_block(self, bid: int, payload) -> None:
        """Host->device restore of one KV page (the swap-in half): stages
        the payload (a no-op if the copy worker already uploaded it) and
        copies it into the pool at ``bid`` in place — the block table
        indirection makes the new bid transparent to attention."""
        staged = self.stage_payload(payload)
        for seg, seg_payload in zip(self.pages, staged):
            for pg, blk in zip(seg, seg_payload):
                for name in ("k", "v"):
                    pg[name][:, bid].copy_(blk[name])

    def write_block_lazy(self, bid: int, payload) -> None:
        """Protocol completeness: paged KV has no lazy restore (attention
        reads every cached position, so every restored page must be device-
        resident) — a lazy write is a full write."""
        self.write_block(bid, payload)

    def bytes_per_block(self, n_tokens: int) -> int:
        """Link weight of one block holding ``n_tokens`` (per-token KV)."""
        return self.io.block_bytes(n_tokens)

    # ------------------------------------------------------------- API
    @torch.inference_mode()
    def prefill_chunk(self, token_chunk: Sequence[int], ctx_len: int,
                      block_table: Sequence[int],
                      rid: Optional[int] = None) -> np.ndarray:
        sc = self.chunk_size
        chunk_len = len(token_chunk)
        toks = np.zeros((sc,), np.int64)
        toks[:chunk_len] = token_chunk
        bt = np.zeros((self.max_pages,), np.int32)
        bt[: len(block_table)] = block_table
        toks_d, bt_d = self._to_device(toks), self._to_device(bt)
        positions = (ctx_len + torch.arange(sc, device=self.device))[None]
        rope = self._rope_for(positions)
        h = self.params["embed"][toks_d][None]                       # (1,Sc,d)
        # slot indices shared by every layer: the chunk's live rows, and the
        # whole table (padded with page 0; causality masks the padding)
        bs = self.page_size
        write_idx = _flat_slots(bt_d, positions[0, :chunk_len], bs)
        gather_idx = _flat_slots(
            bt_d, torch.arange(self.max_pages * bs, device=self.device), bs)

        def attn_fn(p, cfg, x, cos, sin, kp, vp):
            return _attn_prefill_paged(p, cfg, x, cos, sin, kp, vp, write_idx,
                                       gather_idx, ctx_len, impl=self.attn_impl)
        h = self._run_stack(h, rope, attn_fn)
        h_last = h[0, max(chunk_len - 1, 0)]
        return self._final_logits(h_last[None])[0].float().cpu().numpy()

    @torch.inference_mode()
    def decode(self, tokens: Sequence[int], block_tables: List[Sequence[int]],
               pos: Sequence[int],
               rids: Optional[Sequence[int]] = None) -> np.ndarray:
        b = len(tokens)
        bpad = 1 << (b - 1).bit_length() if b > 1 else 1
        toks = np.zeros((bpad,), np.int64)
        toks[:b] = tokens
        bts = np.zeros((bpad, self.max_pages), np.int32)
        for i, bt in enumerate(block_tables):
            bts[i, : len(bt)] = bt
        ps = np.full((bpad,), -1, np.int32)   # -1 marks padded rows (no write)
        ps[:b] = pos
        toks_d, bts_d, ps_d = (self._to_device(a) for a in (toks, bts, ps))
        rope = self._rope_for(torch.clamp(ps_d, min=0)[:, None])
        h = self.params["embed"][toks_d][:, None]                    # (B,1,d)
        # shared by every layer: padded rows (pos -1) get ctx 0 and no write
        ctx_lens = ps_d + 1
        write_idx = _flat_slots(bts_d[:b], ps_d[:b, None].long(),
                                self.page_size)[:, 0]

        def attn_fn(p, cfg, x, cos, sin, kp, vp):
            return _attn_decode_paged(p, cfg, x, cos, sin, kp, vp, bts_d,
                                      ctx_lens, write_idx, impl=self.attn_impl)
        h = self._run_stack(h, rope, attn_fn)
        logits = self._final_logits(h[:b, 0])
        return logits.float().cpu().numpy()
