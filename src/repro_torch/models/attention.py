"""GQA attention: train / prefill / decode, full-causal or sliding-window.

The port of ``repro/models/attention.py``. The paged runner uses only the
projections (``_qkv``) and attends through ``repro_torch.kernels``. The
dense path (``Model.prefill`` / ``decode_step``, and the hybrid family's
state runner) uses ``attn_context`` and ``attn_decode`` here, in plain
PyTorch as the JAX package computes them outside any Pallas kernel.

Decode uses a unified ring-buffer cache: the write slot is ``pos % S_cache``
and valid slots are ``min(pos+1, S_cache)``. When ``S_cache`` >= max
position this degenerates to an ordinary append cache; when smaller it is a
sliding window (keys are stored post-RoPE, so slot order is irrelevant).
The ring is written functionally, as JAX's ``.at[].set``: ``attn_decode``
returns new cache tensors and never writes into the ones it was given,
which may be a stored snapshot.

On DTensors (a mesh, ``repro_torch.launch.sharding``) the attention itself
(scores, mask, softmax, the weighted values; the ring write in decode)
runs through ``local_map`` on each rank's batch rows, kv groups and query
rows, as the scans do, and so does the output projection; the q, k and v
projections stay DTensor ops.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.ops import as_placements, contiguous_grads, follow
from repro_torch.models.common import apply_rope, dense_init, rms_norm
from repro_torch.models.hooks import constrain

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg, dtype, lead=()):
    """Attention weights; ``lead`` prepends a stacked-layer axis."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, (d, hq, hd), d, dtype, lead),
        "wk": dense_init(gen, (d, hkv, hd), d, dtype, lead),
        "wv": dense_init(gen, (d, hkv, hd), d, dtype, lead),
        "wo": dense_init(gen, (hq, hd, d), hq * hd, dtype, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=gen.device)
    return p


def _proj(x, w):
    """x (B,S,d) through w (d,H,hd) -> (B,S,H,hd). On a DTensor it runs
    through ``local_map``, per mesh dim: where w's heads are sharded each
    rank gives its heads (x whole there, its gradient a partial sum);
    else a batch shard of x carries through (w's gradient a partial sum);
    any other shard of x is gathered first. (Left to DTensor, the weight
    gradient is a product over the batch and sequence flattened together,
    whose sharding DTensor plans slowly when both are split.)"""
    if not isinstance(x, DTensor):
        return torch.einsum("bsd,dhk->bshk", x, w)
    mesh = x.device_mesh
    x_pl, w_pl, y_pl, x_grad, w_grad = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if wp == Shard(1):
            x_pl.append(Replicate()), w_pl.append(wp), y_pl.append(Shard(2))
            x_grad.append(Partial()), w_grad.append(wp)
        elif xp == Shard(0):
            x_pl.append(xp), w_pl.append(Replicate()), y_pl.append(xp)
            x_grad.append(xp), w_grad.append(Partial())
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), y_pl.append(Replicate())
            x_grad.append(Replicate()), w_grad.append(Replicate())
    fn = local_map(lambda a, b: torch.einsum("bsd,dhk->bshk", *contiguous_grads(a, b)),
                   out_placements=y_pl, in_placements=(tuple(x_pl), tuple(w_pl)),
                   in_grad_placements=(tuple(x_grad), tuple(w_grad)), device_mesh=mesh)
    return fn(as_placements(x, mesh, x_pl), as_placements(w, mesh, w_pl))


def _qkv(params, cfg, x, cos, sin):
    """x (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd): projections, qk-norm
    over head_dim, then RoPE. Query head h reads kv head h // (Hq/Hkv)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # "seq_fallback": where the head count does not divide the model axis,
    # the query's sequence dim shards instead (sequence-parallel attention)
    q = constrain(q, ("batch", "seq_fallback", "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    return q, k, v


def _attn_placements(q, hkv):
    """Where a DTensor query (B,S,Hq,hd) is attended, per mesh dim: a batch
    or sequence shard stays; a head shard stays where the mesh dim's m
    ranks divide Hkv (each rank then holds whole kv groups), else it moves
    to the sequence dim where m divides S (sequence-parallel attention, as
    ``seq_fallback`` shards a head count that does not fit), else it is
    gathered."""
    mesh, s = q.device_mesh, q.shape[1]
    out = []
    for i, p in enumerate(q.placements):
        m = mesh.size(i)
        if p == Shard(0) or p == Shard(1) or (p == Shard(2) and hkv % m == 0):
            out.append(p)
        elif p == Shard(2) and s % m == 0 and Shard(1) not in q.placements + tuple(out):
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return tuple(out)


def _out_proj(out, wo):
    """out (B,S,Hq,hd) through wo (Hq,hd,d) -> (B,S,d). On a DTensor it runs
    through ``local_map`` on each rank's shard of out: head-sharded rows
    meet the matching rows of wo and give a partial sum (Megatron's
    row-parallel product), batch and sequence shards carry through, and
    wo's gradient from batch or sequence shards is a partial sum."""
    if not isinstance(out, DTensor):
        return torch.einsum("bshk,hkd->bsd", out, wo)
    mesh, o_pl = out.device_mesh, tuple(out.placements)
    w_pl = follow(o_pl, {2: Shard(0)})
    w_grad = follow(o_pl, {0: Partial(), 1: Partial(), 2: Shard(0)})
    y_pl = follow(o_pl, {0: Shard(0), 1: Shard(1), 2: Partial()})
    fn = local_map(lambda o, w: torch.einsum("bshk,hkd->bsd", *contiguous_grads(o, w)),
                   out_placements=list(y_pl), in_placements=(o_pl, w_pl),
                   in_grad_placements=(o_pl, w_grad), device_mesh=mesh)
    return fn(out, as_placements(wo, mesh, w_pl))


def _grouped_scores(q, k):
    """q (B,S,Hq,hd), k (B,T,Hkv,hd) -> scores (B,Hkv,G,S,T) in fp32."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    return scores / torch.sqrt(torch.tensor(float(hd), device=scores.device))


def _grouped_out(probs, v, dtype):
    """probs (B,Hkv,G,S,T), v (B,T,Hkv,hd) -> (B,S,Hq,hd)."""
    b, hkv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(dtype), v)
    return out.reshape(b, s, hkv * g, -1)


# Context attention switches to the blockwise (flash) path above this
# sequence length: never materializes the S^2 score tensor. Read at call
# time, so tests can lower them.
FLASH_THRESHOLD = 2048
FLASH_BLOCK = 1024


def _flash_grouped(q, k, v, *, window=0, seq_lens=None, blk=None, q_pos=None):
    """Blockwise causal attention (running softmax over KV blocks, a Python
    loop where JAX scans). q (B,S,Hq,hd); k/v (B,T,Hkv,hd), T the sequence
    and ``q_pos`` (S,) the query rows' positions in it (all of them, T = S,
    unless the rows are a shard). Requires T % blk == 0."""
    if blk is None:
        blk = FLASH_BLOCK
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    nb = k.shape[1] // blk
    dev = q.device
    qg = (q.reshape(b, s, hkv, g, hd).float()
          / torch.sqrt(torch.tensor(float(hd), device=dev)))
    if q_pos is None:
        q_pos = torch.arange(s, device=dev)
    i_idx = q_pos[:, None]                               # global q positions

    m = torch.full((b, hkv, g, s, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, s, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, hkv, g, hd), dtype=torch.float32, device=dev)
    for jblk in range(nb):
        k_j = k[:, jblk * blk:(jblk + 1) * blk]          # (B,blk,Hkv,hd)
        v_j = v[:, jblk * blk:(jblk + 1) * blk]
        sc = torch.einsum("bskgd,btkd->bkgst", qg, k_j.float())   # (B,Hkv,G,S,blk)
        j_idx = jblk * blk + torch.arange(blk, device=dev)[None, :]
        mask = j_idx <= i_idx
        if window:
            mask &= (i_idx - j_idx) < window
        if seq_lens is not None:
            mask = mask[None] & (j_idx[None] < seq_lens[:, None, None])
            mask = mask[:, None, None]
        else:
            mask = mask[None, None, None]
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)                     # (B,Hkv,G,S,1)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha.permute(0, 3, 1, 2, 4) + torch.einsum(
            "bkgst,btkd->bskgd", p, v_j.float())
        m = m_new
    denom = l.permute(0, 3, 1, 2, 4)                     # (B,S,Hkv,G,1)
    out = acc / torch.clamp(denom, min=1e-20)
    return out.reshape(b, s, hq, hd).to(q.dtype)


def _context_core(q, k, v, q_pos, seq_lens, *, window, flash):
    """Causal attention of q (B,S,Hq,hd) at positions ``q_pos`` (S,) over
    k/v (B,T,Hkv,hd) -> (B,S,Hq,hd): blockwise (``_flash_grouped``) or
    through the whole score tensor."""
    if flash:
        return _flash_grouped(q, k, v, window=window, seq_lens=seq_lens, q_pos=q_pos)
    scores = _grouped_scores(q, k)                        # (B,Hkv,G,S,T)
    i = q_pos[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= (i - j) < window
    if seq_lens is not None:                              # right-padding mask
        mask = mask[None] & (j[None] < seq_lens[:, None, None])
        mask = mask[:, None, None]
    else:
        mask = mask[None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v, q.dtype)


def _context(q, k, v, seq_lens, *, window, flash):
    """``_context_core`` over the whole sequence. On a DTensor it runs
    through ``local_map`` on each rank's shard (``_attn_placements``):
    batch rows, kv groups and query rows are independent, so each rank
    attends its query rows over its batch rows' and groups' keys. Keys and
    values whole on the ranks that split the query rows get their gradient
    as a partial sum there."""
    q_pos = torch.arange(q.shape[1], device=q.to_local().device
                         if isinstance(q, DTensor) else q.device)
    if not isinstance(q, DTensor):
        return _context_core(q, k, v, q_pos, seq_lens, window=window, flash=flash)
    mesh = q.device_mesh
    q_pl = _attn_placements(q, k.shape[2])
    kv_pl = follow(q_pl, {0: Shard(0), 2: Shard(2)})
    kv_grad = follow(q_pl, {0: Shard(0), 1: Partial(), 2: Shard(2)})
    pos_pl = follow(q_pl, {1: Shard(0)})
    lens_pl = follow(q_pl, {0: Shard(0)})
    ins = [as_placements(q, mesh, q_pl), as_placements(k, mesh, kv_pl),
           as_placements(v, mesh, kv_pl), as_placements(q_pos, mesh, pos_pl)]
    in_pl = [q_pl, kv_pl, kv_pl, pos_pl]
    grad_pl = [q_pl, kv_grad, kv_grad, pos_pl]
    if seq_lens is not None:
        ins.append(as_placements(seq_lens, mesh, lens_pl))
        in_pl.append(lens_pl)
        grad_pl.append(lens_pl)

    def local(ql, kl, vl, pl, lens=None):
        return _context_core(*contiguous_grads(ql, kl, vl), pl, lens, window=window,
                             flash=flash)
    fn = local_map(local, out_placements=list(q_pl), in_placements=tuple(in_pl),
                   in_grad_placements=tuple(grad_pl), device_mesh=mesh)
    return fn(*ins)


def attn_context(params, cfg, x, cos, sin, *, window=0, seq_lens=None,
                 return_cache=False):
    """Full-context attention (train / prefill). x: (B,S,d)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, cos, sin)
    out = _context(q, k, v, seq_lens, window=window,
                   flash=s >= FLASH_THRESHOLD and s % FLASH_BLOCK == 0)
    out = _out_proj(out, params["wo"])
    cache = {"k": k, "v": v} if return_cache else None
    return out, cache


def _decode_core(q, k_ring, v_ring, k_new, v_new, pos):
    """One query row per batch row: the new key and value written into
    the rings at slot pos % S_cache (new tensors), then attention over the
    valid slots. Returns (out (B,1,Hq,hd), k, v)."""
    b, s_cache = k_ring.shape[:2]
    pos = pos.long()
    slot = pos % s_cache
    bidx = torch.arange(b, device=q.device)
    k = k_ring.index_put((bidx, slot), k_new[:, 0])
    v = v_ring.index_put((bidx, slot), v_new[:, 0])
    scores = _grouped_scores(q, k)                        # (B,Hkv,G,1,Sc)
    valid = torch.clamp(pos + 1, max=s_cache)             # (B,)
    mask = torch.arange(s_cache, device=q.device)[None, :] < valid[:, None]
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v, q.dtype), k, v


def attn_decode(params, cfg, x, cos, sin, cache, pos):
    """One-token decode. x: (B,1,d); cache k/v: (B,Sc,Hkv,hd); pos: (B,) int.
    Returns new k/v rings; the given ones are left as they were. On a
    DTensor the write and the attention run through ``local_map`` on each
    rank's batch rows and kv groups; a ring sharded on its slots (kv heads
    that do not divide the `model` ranks) is gathered for it and the new
    ring cut back to that layout."""
    q, k_new, v_new = _qkv(params, cfg, x, cos, sin)      # seq dim == 1
    if not isinstance(q, DTensor):
        out, k, v = _decode_core(q, cache["k"], cache["v"], k_new, v_new, pos)
    else:
        mesh = q.device_mesh
        q_pl = _attn_placements(q, k_new.shape[2])
        kv_pl = follow(q_pl, {0: Shard(0), 2: Shard(2)})
        pos_pl = follow(q_pl, {0: Shard(0)})
        fn = local_map(_decode_core, out_placements=(list(q_pl), list(kv_pl), list(kv_pl)),
                       in_placements=(q_pl, kv_pl, kv_pl, kv_pl, kv_pl, pos_pl),
                       device_mesh=mesh)
        out, k, v = fn(as_placements(q, mesh, q_pl), as_placements(cache["k"], mesh, kv_pl),
                       as_placements(cache["v"], mesh, kv_pl), as_placements(k_new, mesh, kv_pl),
                       as_placements(v_new, mesh, kv_pl), as_placements(pos, mesh, pos_pl))
        k = as_placements(k, mesh, cache["k"].placements)
        v = as_placements(v, mesh, cache["v"].placements)
    return _out_proj(out, params["wo"]), {"k": k, "v": v}
