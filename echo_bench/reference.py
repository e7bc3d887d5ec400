"""The plain reference: a float32 PyTorch forward of whole sequences.

It follows the architecture as the configuration file states it (a
pre-norm decoder: RMSNorm, grouped-query attention with rotate-half RoPE
and optional per-head qk-norm, a SwiGLU MLP, a final RMSNorm, logits
through the unembedding or the tied embedding) with plain ``torch``
operations in float32: no kernel of the port, no cache, no batching across
sequences, no TF32 (``plain_float32`` turns it off). It imports nothing of
the program and reads only the benchmark's own weights, cast to float32 one
layer at a time, so that it fits beside them. RoPE angles are computed in
float64.

``quant="fp8"`` is the control: the same forward with every projection's
weight and input rounded to float8 e4m3 (weights one scale a matrix,
inputs one scale a token, as fp8 serving does), the precision a later
change would be tempted to serve in. The embedding, attention and logits
stay float32.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

FP8_MAX = 448.0          # the largest finite float8 e4m3 value


def plain_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (None: one for the whole tensor), back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = (amax / FP8_MAX).clamp_min(1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Linear:
    """x @ w, w (in, out) float32; under fp8 both rounded first."""

    def __init__(self, w: torch.Tensor, quant):
        self.quant = quant
        self.w = _fp8(w, None) if quant == "fp8" else w

    def __call__(self, x):
        if self.quant == "fp8":
            x = _fp8(x, -1)
        return x @ self.w


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _angles(n, hd, theta, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]


def _layer_weights(m, params, i, quant):
    lay = params["layers"][0][0]
    d, hq, hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a, mlp = lay["attn"], lay["mlp"]
    f = {k: lay[k][i].float() for k in ("ln1", "ln2")}
    f["wq"] = _Linear(a["wq"][i].float().reshape(d, hq * hd), quant)
    f["wk"] = _Linear(a["wk"][i].float().reshape(d, hkv * hd), quant)
    f["wv"] = _Linear(a["wv"][i].float().reshape(d, hkv * hd), quant)
    f["wo"] = _Linear(a["wo"][i].float().reshape(hq * hd, d), quant)
    for k in ("w1", "w3", "w2"):
        f[k] = _Linear(mlp[k][i].float(), quant)
    if m["qk_norm"]:
        f["q_norm"], f["k_norm"] = a["q_norm"][i].float(), a["k_norm"][i].float()
    return f


def _attention(q, k, v, q_block):
    """Causal attention of one sequence: q (T,Hkv,G,hd), k/v (T,Hkv,hd) ->
    (T, Hkv*G*hd), a block of query rows at a time."""
    t, hkv, g, hd = q.shape
    out = torch.empty((t, hkv * g * hd), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, t, q_block):
        b = min(a + q_block, t)
        s = torch.einsum("qkgd,tkd->kgqt", q[a:b], k[:b]) * scale
        mask = (torch.arange(b, device=q.device)[None, :]
                > torch.arange(a, b, device=q.device)[:, None])
        s = s.masked_fill(mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("kgqt,tkd->qkgd", p, v[:b]).reshape(b - a, -1)
    return out


def _block(m, f, h, cos, sin, q_block, row_block):
    t = h.shape[0]
    hq, hkv, hd, eps = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["norm_eps"]
    x = _rms(h, f["ln1"], eps)
    q = f["wq"](x).view(t, hq, hd)
    k = f["wk"](x).view(t, hkv, hd)
    v = f["wv"](x).view(t, hkv, hd)
    if m["qk_norm"]:
        q, k = _rms(q, f["q_norm"], eps), _rms(k, f["k_norm"], eps)
    q, k = _rope(q, cos[:t], sin[:t]), _rope(k, cos[:t], sin[:t])
    att = _attention(q.view(t, hkv, hq // hkv, hd), k, v, q_block)
    h = h + f["wo"](att)
    for a in range(0, t, row_block):
        x = _rms(h[a:a + row_block], f["ln2"], eps)
        h[a:a + row_block] += f["w2"](torch.nn.functional.silu(f["w1"](x)) * f["w3"](x))
    return h


@torch.no_grad()
def logits_at(m: dict, params, seqs: Sequence[Sequence[int]],
              rows: Sequence[Sequence[int]], *, quant=None, q_block: int = 1024,
              row_block: int = 8192) -> List[torch.Tensor]:
    """Float32 logits (len(rows[i]), vocab) of each sequence at its
    ``rows`` (positions whose next token is wanted). The layers run one at
    a time over every sequence, so each layer's weights are cast once."""
    plain_float32()
    emb = params["embed"]
    dev = emb.device
    hs = [emb[torch.as_tensor(list(s), device=dev)].float() for s in seqs]
    cos, sin = _angles(max(len(s) for s in seqs), m["head_dim"], m["rope_theta"], dev)
    for i in range(m["num_layers"]):
        f = _layer_weights(m, params, i, quant)
        hs = [_block(m, f, h, cos, sin, q_block, row_block) for h in hs]
        del f
    out_w = (params["embed"].float().T if m["tie_embeddings"]
             else params["unembed"].float())
    fin = params["final_ln"].float()
    out = []
    for h, r in zip(hs, rows):
        x = _rms(h[torch.as_tensor(list(r), device=dev)], fin, m["norm_eps"])
        out.append(x @ out_w)
    return out


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's
    best at its row."""
    return ref.max(dim=-1).values - ref.gather(-1, tokens[:, None])[:, 0]
