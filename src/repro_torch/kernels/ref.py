"""Plain PyTorch versions of the attention kernels (and the engine's CPU path).

Each follows ``repro/kernels/ref.py`` operation for operation: scores in the
input dtype then float32, a ``NEG_INF = -1e30`` mask (not -inf), float32
softmax, and probabilities cast back to ``q.dtype`` before the PV product.

``cuda_calls`` on each function counts calls with CUDA tensors. The serving
path never makes one (a CUDA tensor goes to the kernel), so a run can check
that it stayed at zero; only a kernel-vs-plain comparison calls them there.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _inv_sqrt_scale(scores, hd):
    return scores / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                            device=scores.device))


def ref_paged_attention(q, k_pages, v_pages, block_tables, ctx_lens):
    """Decode attention over a block-paged KV cache.

    q:            (B, Hq, hd)     query for the current token
    k/v_pages:    (P, bs, Hkv, hd) global page pool
    block_tables: (B, nblk) int   page ids per sequence (padded arbitrarily)
    ctx_lens:     (B,) int        tokens valid per sequence (incl. current)
    Returns (B, Hq, hd).
    """
    if q.is_cuda:
        ref_paged_attention.cuda_calls += 1
    b, hq, hd = q.shape
    p, bs, hkv, _ = k_pages.shape
    nblk = block_tables.shape[1]
    t = nblk * bs
    flat_k = k_pages.reshape(p * bs, hkv, hd)
    flat_v = v_pages.reshape(p * bs, hkv, hd)
    tok = torch.arange(t, device=q.device)
    idx = block_tables.long()[:, tok // bs] * bs + tok % bs      # (B, T)
    k = flat_k[idx]                                              # (B,T,Hkv,hd)
    v = flat_v[idx]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k).float()
    scores = _inv_sqrt_scale(scores, hd)
    mask = tok[None, :] < ctx_lens.long()[:, None]               # (B,T)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(q.dtype), v)
    return out.reshape(b, hq, hd)


ref_paged_attention.cuda_calls = 0


def ref_chunked_prefill_attention(q, k, v, ctx_len):
    """Flash-prefill oracle: q chunk attends to resident prefix + itself.

    q:       (Sc, Hq, hd)  chunk queries (absolute pos = ctx_len + i)
    k/v:     (T, Hkv, hd)  gathered keys: prefix tokens then chunk tokens;
                           rows >= ctx_len + Sc are padding.
    ctx_len: int
    Returns (Sc, Hq, hd).
    """
    if q.is_cuda:
        ref_chunked_prefill_attention.cuda_calls += 1
    sc, hq, hd = q.shape
    t, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(sc, hkv, g, hd)
    scores = torch.einsum("skgd,tkd->kgst", qg, k).float()
    scores = _inv_sqrt_scale(scores, hd)
    i = torch.arange(sc, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = j <= (int(ctx_len) + i)                               # causal w/ offset
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("kgst,tkd->skgd", probs.to(q.dtype), v)
    return out.reshape(sc, hq, hd)


ref_chunked_prefill_attention.cuda_calls = 0
