"""Plain PyTorch versions of the kernels (and the engine's CPU path).

Each follows ``repro/kernels/ref.py`` operation for operation. Attention:
scores in the input dtype then float32, a ``NEG_INF = -1e30`` mask (not
-inf), float32 softmax, and probabilities cast back to ``q.dtype`` before
the PV product. The SSD scan: the token-by-token recurrence, the oracle of
the chunked version in ``repro_torch/kernels/ssd_scan.py``. The RG-LRU
scan: the token-by-token linear recurrence, and its adjoint walked back
token by token (the plain backward).

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


def ref_rglru_scan(a, b):
    """Sequential RG-LRU recurrence oracle: h_t = a_t h_{t-1} + b_t.

    a, b: (B, S, W) -> (B, S, W) fp32."""
    if a.is_cuda:
        ref_rglru_scan.cuda_calls += 1
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0])
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1)


ref_rglru_scan.cuda_calls = 0


def ref_rglru_scan_bwd(a, h, g):
    """Adjoint of ``ref_rglru_scan``: a (B,S,W), the forward's h (B,S,W)
    and g = dL/dh (B,S,W) -> (da, db), walking time backwards:
    lam_{S-1} = g_{S-1}, lam_t = g_t + a_{t+1} lam_{t+1}; db_t = lam_t and
    da_t = lam_t h_{t-1}, with h_{-1} = 0. In float32, or in float64 from
    float64 a (the gradient checks run there)."""
    if a.is_cuda:
        ref_rglru_scan_bwd.cuda_calls += 1
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    a, h, g = a.to(dt), h.to(dt), g.to(dt)
    lam = torch.zeros_like(g[:, 0])
    da, db = [], []
    for t in reversed(range(a.shape[1])):
        lam = g[:, t] + (a[:, t + 1] * lam if t + 1 < a.shape[1] else 0.0)
        db.append(lam)
        da.append(lam * h[:, t - 1] if t > 0 else torch.zeros_like(lam))
    return torch.stack(da[::-1], dim=1), torch.stack(db[::-1], dim=1)


ref_rglru_scan_bwd.cuda_calls = 0


def ref_ssd_sequential(x, dt_a, b_mat, c_mat, initial_state=None):
    """Sequential SSD scan oracle.

    x:     (B, S, H, P)  dt-scaled inputs
    dt_a:  (B, S, H)     A*dt (negative)
    b/c:   (B, S, N)
    initial_state: optional (B, H, P, N) state before the first token
    Returns (y (B,S,H,P), final_state (B,H,P,N)). fp32 math.
    """
    if x.is_cuda:
        ref_ssd_sequential.cuda_calls += 1
    bs, s, h, p = x.shape
    n = b_mat.shape[-1]
    x, dt_a, b_mat, c_mat = (t.float() for t in (x, dt_a, b_mat, c_mat))
    state = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt_a[:, t])[..., None, None]
                 + x[:, t, :, :, None] * b_mat[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_mat[:, t]))
    return torch.stack(ys, dim=1), state


ref_ssd_sequential.cuda_calls = 0
