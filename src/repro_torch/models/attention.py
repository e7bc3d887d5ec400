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
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_rope, dense_init, rms_norm

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


def _qkv(params, cfg, x, cos, sin):
    """x (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd): projections, qk-norm
    over head_dim, then RoPE. Query head h reads kv head h // (Hq/Hkv)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


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


def _flash_grouped(q, k, v, *, window=0, seq_lens=None, blk=None):
    """Blockwise causal attention (running softmax over KV blocks, a Python
    loop where JAX scans). q (B,S,Hq,hd); k/v (B,S,Hkv,hd). Requires
    S % blk == 0."""
    if blk is None:
        blk = FLASH_BLOCK
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    nb = s // blk
    dev = q.device
    qg = (q.reshape(b, s, hkv, g, hd).float()
          / torch.sqrt(torch.tensor(float(hd), device=dev)))
    i_idx = torch.arange(s, device=dev)[:, None]         # global q positions

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


def attn_context(params, cfg, x, cos, sin, *, window=0, seq_lens=None,
                 return_cache=False):
    """Full-context attention (train / prefill). x: (B,S,d)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, cos, sin)
    if s >= FLASH_THRESHOLD and s % FLASH_BLOCK == 0:
        out = _flash_grouped(q, k, v, window=window, seq_lens=seq_lens)
    else:
        scores = _grouped_scores(q, k)                    # (B,Hkv,G,S,T=S)
        i = torch.arange(s, device=x.device)[:, None]
        j = torch.arange(s, device=x.device)[None, :]
        mask = j <= i
        if window:
            mask &= (i - j) < window
        if seq_lens is not None:                          # right-padding mask
            mask = mask[None] & (j[None] < seq_lens[:, None, None])
            mask = mask[:, None, None]
        else:
            mask = mask[None, None, None]
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = _grouped_out(probs, v, x.dtype)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    cache = {"k": k, "v": v} if return_cache else None
    return out, cache


def attn_decode(params, cfg, x, cos, sin, cache, pos):
    """One-token decode. x: (B,1,d); cache k/v: (B,Sc,Hkv,hd); pos: (B,) int.
    Returns new k/v rings; the given ones are left as they were."""
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    q, k_new, v_new = _qkv(params, cfg, x, cos, sin)      # seq dim == 1
    pos = pos.long()
    slot = pos % s_cache
    bidx = torch.arange(b, device=x.device)
    k = cache["k"].index_put((bidx, slot), k_new[:, 0])
    v = cache["v"].index_put((bidx, slot), v_new[:, 0])
    scores = _grouped_scores(q, k)                        # (B,Hkv,G,1,Sc)
    valid = torch.clamp(pos + 1, max=s_cache)             # (B,)
    mask = torch.arange(s_cache, device=x.device)[None, :] < valid[:, None]
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _grouped_out(probs, v, x.dtype)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return out, {"k": k, "v": v}
