"""Runner-agnostic block I/O economics for the tiered memory layer.

Every runner family that can park blocks on the host tier speaks the same
split-phase protocol (``snapshot_block`` / ``materialize`` /
``stage_payload`` / ``write_block`` — see ``PagedRunner`` and
``StateRunner``), but what a "block" *moves over the link* differs per
family:

  * **paged** (attention KV): a block's payload is per-token KV pages —
    ``n_tokens * bytes_per_token`` — and a restore needs the *whole
    prefix* resident (attention reads every cached position).
  * **state** (SSM / RG-LRU recurrent snapshots): a block's payload is
    one fixed-size state pytree captured at the block boundary, and a
    restore needs only the *last* boundary snapshot uploaded — the
    recurrence resumes from it; earlier boundaries matter only for
    future mid-prefix resumes and land host-side for free
    (``restore_last_only``).

``BlockIOSpec`` captures exactly that: it prices transfers in **bytes**
(the resource the PCIe link actually spends) so the TimeModel, the
scheduler's swap-in-vs-recompute race, eviction punishment, and the
calibrator all charge a state snapshot and a KV page by what they move,
not by a token count that means different things per family.
"""
from __future__ import annotations

from dataclasses import dataclass

KV_BYTES_PER_TOKEN_8B = 131072   # 32 layers x 8 kv-heads x 128 hd x 2(kv) x fp16


@dataclass(frozen=True)
class BlockIOSpec:
    """Byte pricing of one BlockManager block for a runner family."""
    family: str = "paged"                          # "paged" | "state"
    bytes_per_token: int = KV_BYTES_PER_TOKEN_8B   # paged: per-token payload
    block_bytes_fixed: int = 0                     # state: snapshot size
    restore_last_only: bool = False                # state: resume from last

    def block_bytes(self, n_tokens: int) -> int:
        """Bytes one block holding ``n_tokens`` moves when parked (or
        restored individually): the paged payload scales with tokens, the
        state snapshot is fixed-size regardless of the boundary's depth."""
        if n_tokens <= 0:
            return 0
        if self.family == "state":
            return self.block_bytes_fixed
        return self.bytes_per_token * n_tokens

    def restore_bytes(self, n_tokens: int, block_size: int) -> int:
        """Bytes a swap-in of ``n_tokens`` (whole blocks) puts on the link.
        Paged KV uploads every restored page; a ``restore_last_only``
        family uploads one snapshot — the last boundary — and re-registers
        the intermediate payloads host-side without touching the link."""
        if n_tokens <= 0:
            return 0
        if self.family == "state":
            if self.restore_last_only:
                return self.block_bytes_fixed
            n_blocks = (n_tokens + block_size - 1) // block_size
            return n_blocks * self.block_bytes_fixed
        return self.bytes_per_token * n_tokens


def paged_spec(bytes_per_token: int = KV_BYTES_PER_TOKEN_8B) -> BlockIOSpec:
    return BlockIOSpec(family="paged", bytes_per_token=bytes_per_token)


def state_spec(block_bytes: int, *, restore_last_only: bool = True) -> BlockIOSpec:
    return BlockIOSpec(family="state", bytes_per_token=0,
                       block_bytes_fixed=block_bytes,
                       restore_last_only=restore_last_only)


def io_spec_for_model(model) -> BlockIOSpec:
    """Derive the byte spec from a model's architecture (duck-typed on the
    ``Model`` facade: ``cfg``, a torch ``dtype``, ``cache_bytes``).
    Attention/MoE stacks are paged; SSM and hybrid stacks snapshot one
    fixed-size state tree per block boundary: for the hybrid RG-LRU family
    its RG-LRU states and local-attention window rings, sized without
    allocating."""
    cfg = model.cfg
    kinds = set(cfg.attn_layers)
    if kinds <= {"attn", "moe"}:
        itemsize = model.dtype.itemsize
        per_tok = (len(cfg.attn_layers) * cfg.num_kv_heads * cfg.head_dim
                   * 2 * itemsize)                       # k + v
        return paged_spec(per_tok)
    state_len = 1 if kinds == {"ssm"} else max(cfg.window, 1)
    return state_spec(model.cache_bytes(1, state_len))
