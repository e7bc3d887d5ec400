"""Offline request pool: length buckets + block-granular radix tree (§6).

The tree is keyed by block_size-token chunks using the *same chain hash* as
the BlockManager, so node counts directly provide the reference count (RC)
of any cached block: rc(h) = number of pooled offline requests whose prompt
passes through chunk-chain h.

Candidate generation for the scheduler: per length bucket, per top-level
subtree (≈ document group), the FCFS-first request — bounded, but captures
the prefix-sharing structure the KV-aware scheduler exploits.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

from repro_torch.core.block_manager import chain_hash
from repro_torch.core.request import Request


class _Node:
    __slots__ = ("children", "count")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}   # chain_hash -> node
        self.count = 0


class OfflinePool:
    def __init__(self, block_size: int, n_buckets: int = 6):
        self.block_size = block_size
        self.n_buckets = n_buckets
        self.buckets: List["OrderedDict[int, Request]"] = \
            [OrderedDict() for _ in range(n_buckets)]
        self.root = _Node()
        self.hash_count: Dict[int, int] = {}     # chain_hash -> passing reqs
        self._chains: Dict[int, List[int]] = {}  # rid -> chain hashes
        self._size = 0

    # ------------------------------------------------------------- basics
    def __len__(self) -> int:
        return self._size

    def __contains__(self, req: Request) -> bool:
        return req.rid in self._chains

    def bucket_of(self, prompt_len: int) -> int:
        """Log2 length buckets starting at 256 tokens: bucket k holds
        prompts in [256*2^k, 256*2^(k+1)), with everything under 512 —
        including sub-256 prompts — in bucket 0 and the last bucket
        open-ended. (A 256-token prompt used to land in bucket 1, stranding
        bucket 0 for sub-256 prompts only, against this doc.)"""
        if prompt_len < 512:
            return 0
        return min(int(math.log2(prompt_len / 256)), self.n_buckets - 1)

    def _chain(self, req: Request) -> List[int]:
        bs = self.block_size
        out, prev = [], 0
        p = req.prompt
        for i in range(len(p) // bs):
            prev = chain_hash(prev, tuple(p[i * bs:(i + 1) * bs]))
            out.append(prev)
        return out

    # ------------------------------------------------------------- add/rm
    def add(self, req: Request) -> None:
        chain = self._chain(req)
        self._chains[req.rid] = chain
        node = self.root
        node.count += 1
        for h in chain:
            node = node.children.setdefault(h, _Node())
            node.count += 1
            self.hash_count[h] = self.hash_count.get(h, 0) + 1
        self.buckets[self.bucket_of(req.prompt_len)][req.rid] = req
        self._size += 1

    def remove(self, req: Request) -> None:
        chain = self._chains.pop(req.rid, None)
        if chain is None:
            return
        # hash_count is decremented for the WHOLE chain (independent of the
        # tree walk — pruning a subtree must not strand deeper counts)
        for h in chain:
            c = self.hash_count.get(h, 0) - 1
            if c <= 0:
                self.hash_count.pop(h, None)
            else:
                self.hash_count[h] = c
        node = self.root
        node.count -= 1
        for h in chain:
            child = node.children.get(h)
            if child is None:
                break
            child.count -= 1
            if child.count <= 0:
                del node.children[h]
                break
            node = child
        self.buckets[self.bucket_of(req.prompt_len)].pop(req.rid, None)
        self._size -= 1

    # ------------------------------------------------------------- queries
    def rc(self, h: int) -> int:
        """Future-reuse count of a cached block hash (paper's RC metadata)."""
        return self.hash_count.get(h, 0)

    def prefix_summary(self) -> Dict[int, int]:
        """Compact radix summary: pooled request count per top-level subtree
        (≈ document group), keyed by first-block chain hash. This is the
        signal a cluster router matches offline work against."""
        return {h: node.count for h, node in self.root.children.items()}

    def group_count(self, h: Optional[int]) -> int:
        """One prefix_summary entry without building the whole dict."""
        node = self.root.children.get(h) if h is not None else None
        return node.count if node is not None else 0

    def group_of(self, req: Request) -> Optional[int]:
        """Top-level subtree key of a pooled request (None if its prompt is
        shorter than one block)."""
        chain = self._chains.get(req.rid)
        return chain[0] if chain else None

    def requests(self) -> Iterable[Request]:
        """All pooled requests, bucket-major insertion order."""
        for bucket in self.buckets:
            yield from bucket.values()

    def fcfs_head(self) -> Optional[Request]:
        best = None
        for bucket in self.buckets:
            for req in bucket.values():
                if best is None or (req.arrival_time, req.rid) < \
                        (best.arrival_time, best.rid):
                    best = req
        return best

    def candidates(self, max_per_bucket: int = 4) -> Iterable[Request]:
        """Representative requests: per bucket, per top-level subtree, the
        FCFS head by (arrival_time, rid) — like ``fcfs_head``. Insertion
        order must not decide: a preempted request is re-``add``-ed at the
        tail of its bucket's OrderedDict, and picking heads by insertion
        order would starve it behind newer arrivals forever.

        Cost: one pass over each bucket plus a sort of the (few) group
        heads — same O(pool) per call as ``fcfs_head``, which the
        non-KV-aware scheduler already pays every iteration."""
        for bucket in self.buckets:
            heads: Dict[int, Request] = {}
            for req in bucket.values():
                chain = self._chains[req.rid]
                group = chain[0] if chain else req.rid
                cur = heads.get(group)
                if cur is None or (req.arrival_time, req.rid) < \
                        (cur.arrival_time, cur.rid):
                    heads[group] = req
            ordered = sorted(heads.values(),
                             key=lambda r: (r.arrival_time, r.rid))
            yield from ordered[:max_per_bucket]

    def peers(self, req: Request, limit: int = 8) -> List[Request]:
        """Requests sharing the longest prefix with ``req`` (batch together)."""
        chain = self._chains.get(req.rid)
        if not chain:
            return []
        node, depth = self.root, 0
        path = []
        for h in chain:
            child = node.children.get(h)
            if child is None:
                break
            path.append(child)
            node = child
        # deepest shared node with count > 1, else top-level group
        target = None
        for nd in reversed(path):
            if nd.count > 1:
                target = nd
                break
        if target is None:
            return []
        out = []
        bucket = self.buckets[self.bucket_of(req.prompt_len)]
        for other in bucket.values():
            if other.rid == req.rid:
                continue
            oc = self._chains[other.rid]
            if len(oc) >= 1 and chain and oc[0] == chain[0]:
                out.append(other)
                if len(out) >= limit:
                    break
        return out
