"""Cluster-global radix index: token-hash → {replica, tier, depth}. The
port's own copy of ``llm_sharding_tpu/runtime/global_index.py`` (stdlib
only); the hash chain is byte-identical, so the two indexes agree key for
key.

Each replica's radix tree is the ground truth for what IT holds, but the
fleet router can only exploit a warm tree it can see. The router's
``ReplicatedServer._pick`` was first made cache-aware by probing every replica's tree
per request (``radix_match_tokens`` under each replica's mutex); at
fleet scale that is N mutex acquisitions on the submit path and it stops
at the process boundary. Mooncake's answer — and this module — is a
single cluster-level index the replicas PUBLISH into as their trees
change, so routing consults one map instead of N trees:

- **Keys are chained block hashes.** A published prefix is reduced to
  ``h_k = blake2b(h_{k-1} || tokens[k*BS:(k+1)*BS])`` and indexed under
  its final (node-boundary) hash — the same whole-block discipline as
  the radix tree, so every entry sits at a depth a lookup walks through.
  A lookup hashes the query prompt once and probes deepest-first; cost
  is O(prompt blocks), independent of fleet size.
- **Values are {replica: tier}.** The deepest match wins; ties break
  warmest-tier-first (hbm > host > disk) — streaming a match back from
  a replica's disk pool still beats recomputing prefill, but an
  HBM-resident copy beats both.
- **It is a ROUTING HINT, not a correctness surface.** Entries can go
  stale (a publish is best-effort) and distinct prefixes can collide;
  the routed replica's real tree governs admission, so the worst case
  of a wrong entry is a re-prefill. Nothing here is load-bearing.

Stdlib-only (hashable token sequences in, plain dicts inside) like
``fairness.py``; thread-safe under one ``cluster.index`` lock that
nests inside the router lock and every replica's serving mutex — see
``analysis/lockorder.ORDER``.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, Iterable, Optional, Tuple

from ..obs.metrics import GLOBAL_INDEX_ENTRIES
from ..analysis.lockorder import named_lock

__all__ = ["GlobalRadixIndex"]

#: Deepest match first; at equal depth the warmer tier wins — promotion
#: cost is HBM < host-stream < disk-stream < full re-prefill.
TIER_WEIGHT = {"hbm": 3, "host": 2, "disk": 1}


class GlobalRadixIndex:
    """The cluster map. Replicas publish through a per-replica closure
    (wired by the router at spawn: ``cache.publish = lambda ids, tier:
    index.publish(key, ids, tier)``); the router and the disagg planner
    read through :meth:`scores` / :meth:`best`."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self._lock = named_lock("cluster.index")
        # chained block hash -> {replica key -> tier}
        self._map: Dict[bytes, Dict[str, str]] = {}
        # replica key -> its live hashes (drop_replica without a scan)
        self._keys: Dict[str, set] = {}
        self.published = 0   # entry upserts
        self.removed = 0     # entry removals (evictions + retires)
        self.lookups = 0
        self.lookup_hits = 0

    # ------------------------------------------------------------ hashing

    def _chain(self, ids: Iterable[int]) -> list:
        """Chained per-block hashes of a token sequence (block-aligned
        floor). Pure — computed outside the lock."""
        toks = [int(t) for t in ids]
        bs = self.block_size
        out, h = [], b""
        for i in range(0, (len(toks) // bs) * bs, bs):
            block = struct.pack(
                f"<{bs}q", *toks[i:i + bs]
            )
            h = hashlib.blake2b(h + block, digest_size=16).digest()
            out.append(h)
        return out

    # ------------------------------------------------------------ publish

    def publish(self, replica: str, prefix_ids, tier: Optional[str]) -> None:
        """Upsert (or with ``tier=None`` remove) one replica's entry at
        the node-boundary depth of ``prefix_ids``. Sub-block tails are
        ignored (the tree never indexes them either)."""
        chain = self._chain(prefix_ids)
        if not chain:
            return
        h = chain[-1]
        with self._lock:
            if tier is None:
                d = self._map.get(h)
                if d and d.pop(replica, None) is not None:
                    self.removed += 1
                    if not d:
                        del self._map[h]
                    keys = self._keys.get(replica)
                    if keys is not None:
                        keys.discard(h)
            else:
                self._map.setdefault(h, {})[replica] = tier
                self._keys.setdefault(replica, set()).add(h)
                self.published += 1
            total = sum(len(d) for d in self._map.values())
        GLOBAL_INDEX_ENTRIES.set(total)

    def drop_replica(self, replica: str) -> int:
        """Forget everything a retiring/failed replica published.
        Returns entries removed."""
        with self._lock:
            keys = self._keys.pop(replica, set())
            n = 0
            for h in keys:
                d = self._map.get(h)
                if d and d.pop(replica, None) is not None:
                    n += 1
                    if not d:
                        del self._map[h]
            self.removed += n
            total = sum(len(d) for d in self._map.values())
        GLOBAL_INDEX_ENTRIES.set(total)
        return n

    # ------------------------------------------------------------- lookup

    def scores(self, prompt_ids, replicas: Iterable[str]) -> Dict[
        str, Tuple[int, int]
    ]:
        """Per-replica ``(match_depth_tokens, tier_weight)`` for a
        prompt — the router's comparison key (deeper beats warmer;
        warmer breaks depth ties). Replicas absent from the index score
        ``(0, 0)``."""
        keys = list(replicas)
        chain = self._chain(prompt_ids)
        out = {r: (0, 0) for r in keys}
        if not chain or not keys:
            return out
        remaining = set(keys)
        bs = self.block_size
        with self._lock:
            self.lookups += 1
            hit = False
            for k in range(len(chain) - 1, -1, -1):
                d = self._map.get(chain[k])
                if not d:
                    continue
                for r in list(remaining):
                    t = d.get(r)
                    if t is not None:
                        out[r] = ((k + 1) * bs, TIER_WEIGHT.get(t, 0))
                        remaining.discard(r)
                        hit = True
                if not remaining:
                    break
            if hit:
                self.lookup_hits += 1
        return out

    def best(
        self, prompt_ids, exclude: Iterable[str] = ()
    ) -> Optional[Tuple[str, str, int]]:
        """Deepest-then-warmest holder of a prompt's prefix:
        ``(replica, tier, depth_tokens)``, or None when the fleet is
        cold for it. ``exclude`` skips replicas (e.g. the routed dst
        when hunting a cross-fill source)."""
        chain = self._chain(prompt_ids)
        if not chain:
            return None
        skip = set(exclude)
        bs = self.block_size
        with self._lock:
            self.lookups += 1
            for k in range(len(chain) - 1, -1, -1):
                d = self._map.get(chain[k])
                if not d:
                    continue
                cands = [
                    (TIER_WEIGHT.get(t, 0), r, t)
                    for r, t in d.items() if r not in skip
                ]
                if not cands:
                    continue
                _, r, t = max(cands)
                self.lookup_hits += 1
                return r, t, (k + 1) * bs
        return None

    # -------------------------------------------------------------- stats

    def entries(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._map.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": sum(len(d) for d in self._map.values()),
                "replicas": sorted(self._keys),
                "published": self.published,
                "removed": self.removed,
                "lookups": self.lookups,
                "lookup_hits": self.lookup_hits,
            }
