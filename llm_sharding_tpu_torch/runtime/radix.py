"""Automatic prefix cache: a radix tree over token ids whose nodes own
refcounted KV arena blocks, with an LRU host-RAM tier and a disk tier
underneath. The port's own copy of ``llm_sharding_tpu/runtime/radix.py``
(``RadixNode`` ``:74``, ``RadixRef`` ``:116``, ``RadixCache`` ``:141``):
that module is numpy and stdlib only, but importing it pulls jax in
through ``llm_sharding_tpu/runtime/__init__.py``. The tree code is the
JAX package's line for line; what differs is stated here.

Shared system prompts, few-shot preambles and multi-turn chat history
arrive with no caller coordination, so prefix reuse must be automatic
(SGLang's RadixAttention, Zheng et al. 2023). An explicit
``PrefixHandle`` (``runtime/server.py``) stays the manual escape hatch.

- **The tree is keyed by token ids from position 0.** KV content is a
  deterministic function of (token prefix, absolute position), and every
  served row lays its prompt out contiguously from position 0 in its
  block table, so a cache block holding tokens ``[i*BS, (i+1)*BS)`` of
  some prompt is byte-reusable by any later request whose prompt starts
  with the same tokens. Edges carry whole blocks: every node's token key
  is a multiple of ``block_size`` long, splits happen only at block
  boundaries, and a divergence inside a block ends the match.
- **Nodes own allocator references.** An inserted block keeps the
  refcount-1 reference its row held (ownership transfers, no copy);
  rows that later map a cached block ``share()`` it, so the
  ``BlockAllocator`` stays the one source of truth for block lifetime.
  ``refs`` on a node counts the rows pinning it; eviction never touches
  a pinned node.
- **HBM is a cache level, not a ceiling.** Under allocator pressure
  (``ensure_free``) cold nodes are evicted in LRU order: first demoted to
  a bounded host-RAM pool (device→host copy of the blocks' K/V, bytes
  unchanged), then, with a disk tier, spilled to ``.npy`` files under a
  bounded on-disk pool, and only then dropped. A later match on a
  demoted node streams it back into fresh device blocks before the row
  admits (disk→host→arena for spilled nodes).
- **The disk pool is a persistent artifact.** Each spilled node is one
  entry: per-component ``.npy`` files plus a meta JSON written last via
  fsync'd tmp+rename, so a crash mid-spill leaves only orphan files that
  ``adopt_pool`` sweeps. A corrupt or missing entry drops the node and
  the request re-prefills: never an error upward.

Two walks of the tree (``evictable_blocks``, ``_candidates``) run
iteratively over ``_post_order`` instead of as recursive closures, in the
same order: a recursive closure is a reference cycle, which would keep a
dropped server's arena alive until the garbage collector runs.

Host copies are numpy arrays with the block axis at position 2: the
owning server's ``read_kv`` returns ``[1, L, nb, BS, Nkv, D]`` (a stage
axis of one, the JAX package's ``[S, Lp, nb, BS, Nkv, Dh]`` layout) and,
for an int8/fp8 arena, the scales ``[1, L, nb, Nkv]``. numpy has no
bfloat16 or float8_e4m3fn, so those arrive as their ``uint16`` / ``uint8``
views; the arena's dtype, which the server holds, is the tag that views
them back on ``write_kv``, and a disk meta naming an extension dtype
reads back as its raw view (``_np_dtype``). The port's disk pool is not
readable by the JAX package, nor the reverse.

The tree is host bookkeeping only; device I/O goes through the two
callbacks. Not thread-safe on its own: the owning server serializes
every call under its mutex, like ``BlockAllocator``. The ``publish``
hook (the cluster index) stays ``None`` in this port until the fleet
slice; it is fired best-effort and can never fail a cache operation.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from typing import Callable, Optional

import numpy as np

from .blocks import BlockAllocator, BlockExhausted

__all__ = ["RadixCache", "RadixNode", "RadixRef"]

# extension dtypes numpy does not know, read back as their raw views
_RAW_VIEWS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the common prefix of two int token arrays."""
    n = min(a.shape[0], b.shape[0])
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class RadixNode:
    """One edge of the tree: ``key`` tokens (a multiple of ``block_size``
    long) backed by ``len(key) // block_size`` arena blocks — device block
    ids in ``blocks`` when resident, or host copies in ``host_kv`` when
    demoted (never both)."""

    __slots__ = (
        "key", "blocks", "host_kv", "host_owners", "disk_entry", "children",
        "parent", "refs", "last_used",
    )

    def __init__(self, key: np.ndarray, blocks, parent):
        self.key = np.asarray(key, np.int32)
        self.blocks: list[int] = list(blocks)
        # Demoted: a tuple of numpy arrays, ALL with the block axis at
        # position 2 — (k, v) for a plain arena, (k, v, k_scale, v_scale)
        # for a quantized one (the owning server's read_kv decides; the
        # tree only ever slices/concatenates along axis 2 and hands the
        # tuple back to write_kv verbatim, so the round trip is byte-exact
        # either way)
        self.host_kv: Optional[tuple] = None
        # Shard-tagged component layout of a demoted node under
        # context-parallel serving: ``host_owners[i]`` is the cp shard
        # that owned block ``i`` of ``host_kv`` at demote time (None at
        # cp=1 or without a ``block_owner`` callback). Purely descriptive
        # — restore lands on fresh allocator-chosen owners — but it lets
        # operators and the chaos suites byte-compare a demote/restore
        # round trip per source shard.
        self.host_owners: Optional[list] = None
        # Spilled: the disk-pool entry id (``e<seq>``) whose files back
        # this node's KV. Exactly one of {blocks, host_kv, disk_entry}
        # describes where the KV lives.
        self.disk_entry: Optional[str] = None
        self.children: dict[int, "RadixNode"] = {}
        self.parent: Optional["RadixNode"] = parent
        self.refs = 0  # live rows pinning this node (admission ↔ release)
        self.last_used = 0

    def on_device(self) -> bool:
        return self.host_kv is None and self.disk_entry is None

    def tier(self) -> str:
        if self.disk_entry is not None:
            return "disk"
        return "host" if self.host_kv is not None else "hbm"


class RadixRef:
    """A pinned match: the path nodes a row holds references on, the
    matched token count ``n`` and the device block ids covering exactly
    those ``n`` tokens (in path order). The server maps ``blocks``
    read-only into the row's table and calls ``release`` when the row
    leaves."""

    __slots__ = ("nodes", "n", "blocks", "tier_tokens")

    def __init__(
        self, nodes: tuple, n: int, blocks: list,
        tier_tokens: Optional[dict] = None,
    ):
        self.nodes = nodes
        self.n = n
        self.blocks = blocks
        # where the matched tokens lived at take() time, e.g.
        # {"hbm": 24, "host": 8, "disk": 0} — sums to ``n``; feeds the
        # tier-labeled hit counter
        self.tier_tokens = tier_tokens if tier_tokens is not None else {
            "hbm": n, "host": 0, "disk": 0,
        }


class RadixCache:
    """Radix-tree prefix index over a ``BlockAllocator``'s arena blocks
    with an optional host-RAM tier. See the module docstring."""

    def __init__(
        self,
        alloc: BlockAllocator,
        block_size: int,
        *,
        host_pool_blocks: int = 0,
        read_kv: Optional[Callable] = None,   # (blocks) -> (k_np, v_np)
        write_kv: Optional[Callable] = None,  # (blocks, k_np, v_np) -> None
        block_owner: Optional[Callable] = None,  # (gid) -> cp shard index
        disk_pool_dir: Optional[str] = None,
        disk_pool_blocks: int = 0,
    ):
        if host_pool_blocks < 0:
            raise ValueError(
                f"host_pool_blocks must be >= 0, got {host_pool_blocks}"
            )
        if host_pool_blocks and (read_kv is None or write_kv is None):
            raise ValueError(
                "a host tier (host_pool_blocks > 0) needs read_kv/write_kv "
                "callbacks to move block KV across the host boundary"
            )
        if disk_pool_blocks < 0:
            raise ValueError(
                f"disk_pool_blocks must be >= 0, got {disk_pool_blocks}"
            )
        if disk_pool_blocks and not disk_pool_dir:
            raise ValueError(
                "a disk tier (disk_pool_blocks > 0) needs a disk_pool_dir "
                "to hold the memory-mapped entry files"
            )
        if disk_pool_blocks and not host_pool_blocks:
            raise ValueError(
                "the disk tier sits below the host pool: disk_pool_blocks "
                "> 0 needs host_pool_blocks > 0 (hbm → host → disk ladder)"
            )
        self.alloc = alloc
        self.block_size = int(block_size)
        self.host_pool_blocks = int(host_pool_blocks)
        self.read_kv = read_kv
        self.write_kv = write_kv
        self.block_owner = block_owner
        self.disk_pool_dir = disk_pool_dir
        self.disk_pool_blocks = int(disk_pool_blocks)
        self._entry_seq = 0
        if disk_pool_blocks:
            os.makedirs(disk_pool_dir, exist_ok=True)
            # never reuse an entry id across restarts: a stale reader
            # (snapshot, operator tooling) must not see a new entry's
            # bytes under an old entry's name
            for fn in os.listdir(disk_pool_dir):
                m = re.match(r"e(\d+)\.", fn)
                if m:
                    self._entry_seq = max(self._entry_seq, int(m.group(1)) + 1)
        # best-effort mirror of every tier transition into the cluster
        # index: ``publish(prefix_ids, tier_or_None)`` — set by the owner
        # after construction, never allowed to fail a cache operation
        self.publish: Optional[Callable] = None
        self.root = RadixNode(np.zeros((0,), np.int32), [], None)
        self._tick = 0
        # running tallies (plain ints; ``stats`` reports them)
        self.device_blocks = 0   # tree-owned blocks resident in HBM
        self.host_blocks = 0     # tree-owned blocks parked in the host pool
        self.disk_blocks = 0     # tree-owned blocks spilled to the disk pool
        self.hit_tokens = 0      # prompt tokens served from the cache
        self.eligible_tokens = 0  # cacheable prompt tokens seen at admission
        self.host_hit_tokens = 0  # tokens streamed back from the host tier
        self.disk_hit_tokens = 0  # tokens promoted back from the disk tier
        self.evictions_to_host = 0
        self.evictions_to_disk = 0
        self.evictions_dropped = 0
        self.disk_corrupt_dropped = 0  # entries lost to corrupt/missing files
        self.inserted_blocks = 0

    # ------------------------------------------------------------- lookup

    def match_tokens(self, ids) -> int:
        """Read-only probe: how many tokens of ``ids`` the tree currently
        covers, rounded down to a block multiple (a router's signal for
        the warmest replica). Touches no refcounts, no LRU state."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        node, off = self.root, 0
        while off < ids.shape[0]:
            child = node.children.get(int(ids[off]))
            if child is None:
                break
            m = _common_len(child.key, ids[off:])
            mb = (m // self.block_size) * self.block_size
            off += mb
            if mb < child.key.shape[0]:
                break
            node = child
        return off

    def _walk(self, ids: np.ndarray, max_tokens: int) -> list:
        """Path of ``(node, tokens_used)`` pairs covering the longest
        block-aligned exact match of ``ids``, capped at ``max_tokens``."""
        path, node, off = [], self.root, 0
        while off < ids.shape[0] and off < max_tokens:
            child = node.children.get(int(ids[off]))
            if child is None:
                break
            lim = min(
                child.key.shape[0], ids.shape[0] - off, max_tokens - off
            )
            m = _common_len(child.key[:lim], ids[off : off + lim])
            mb = (m // self.block_size) * self.block_size
            if mb == 0:
                break
            path.append((child, mb))
            off += mb
            if mb < child.key.shape[0]:
                break
            node = child
        return path

    def take(self, ids, max_tokens: int) -> Optional[RadixRef]:
        """Match ``ids`` against the tree and PIN the covering nodes for a
        row about to admit: bumps LRU, increments ``refs`` along the path,
        and streams any demoted node on the path back to device (fresh
        blocks, ``write_kv``; eviction of *other* cold nodes may run to
        make room). A host restore that cannot fit truncates the match at
        that node. Returns ``None`` on no (block-aligned) match.

        The returned ``RadixRef.blocks`` covers exactly ``ref.n`` tokens;
        the caller maps them read-only (``BlockAllocator.share``) and MUST
        ``release`` the ref when the row leaves, whatever the outcome."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        path = self._walk(ids, max_tokens)
        if not path:
            return None
        self._tick += 1
        # pin the WHOLE path before any restore: a restore's room-making
        # eviction must never be able to touch a later (not-yet-visited)
        # node of this very match — a dropped path node would feed freed
        # block ids into the returned ref
        for node, _ in path:
            node.refs += 1
        nodes, blocks, n = [], [], 0
        tiers = {"hbm": 0, "host": 0, "disk": 0}
        ok = True
        for node, mb in path:
            was = node.tier()
            if ok and (node.on_device() or self._restore(node)):
                node.last_used = self._tick
                nodes.append(node)
                blocks.extend(node.blocks[: mb // self.block_size])
                n += mb
                tiers[was] += mb
            else:
                # a demoted node that cannot stream back truncates the match
                # here; this and every later node drop their provisional pin
                ok = False
                node.refs -= 1
        if n == 0:
            return None
        return RadixRef(tuple(nodes), n, blocks, tiers)

    def pin(self, ref: RadixRef) -> None:
        """Add one more row's pin on an existing ref's path (co-admitted
        batch rows share the match but release independently)."""
        for node in ref.nodes:
            node.refs += 1

    def release(self, ref: RadixRef) -> None:
        """Drop one row's pins (idempotence is the caller's job — the
        server releases exactly once per mapped row)."""
        for node in ref.nodes:
            if node.refs < 1:
                raise AssertionError("radix release without a matching pin")
            node.refs -= 1

    # ------------------------------------------------------------- insert

    def insert(self, ids, blocks) -> set:
        """Index ``ids`` (block-aligned length) whose KV lives in
        ``blocks`` (one id per block, in order — a finishing row's table
        prefix). Where the tree already covers a prefix, the existing
        nodes win and the corresponding caller blocks are NOT consumed;
        the uncovered tail becomes a new node that takes OWNERSHIP of its
        blocks (their allocator reference transfers from the row to the
        tree). Returns the set of consumed block ids — the caller frees
        everything else as usual.

        A divergence inside a block ends the insertion (the partial
        block is never indexable), as does one inside a disk-tier edge
        (an on-disk entry is one immutable file set — splitting it in
        place is not worth the I/O). A divergence at a block boundary
        inside a PINNED edge splits fine: ``_split`` leaves the live
        ``RadixRef``'s pins on the bottom node, and the new unpinned top
        is structurally eviction-proof while its descendant is pinned —
        correctness never depends on indexing everything, but the
        co-admitted-shorter-prompt prefix used to be silently dropped
        here and is now attached."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        bs = self.block_size
        if ids.shape[0] % bs:
            raise ValueError(
                f"insert length {ids.shape[0]} is not a multiple of the "
                f"block size {bs}"
            )
        blocks = list(blocks)
        if len(blocks) != ids.shape[0] // bs:
            raise ValueError(
                f"{len(blocks)} blocks do not cover {ids.shape[0]} tokens "
                f"at block size {bs}"
            )
        self._tick += 1
        consumed: set = set()
        node, off, bi = self.root, 0, 0
        while off < ids.shape[0]:
            child = node.children.get(int(ids[off]))
            if child is None:
                tail = RadixNode(ids[off:], blocks[bi:], node)
                tail.last_used = self._tick
                node.children[int(ids[off])] = tail
                consumed.update(blocks[bi:])
                self.alloc.mark_cached(blocks[bi:])
                self.device_blocks += len(blocks) - bi
                self.inserted_blocks += len(blocks) - bi
                self._publish(tail, "hbm")
                break
            m = _common_len(child.key, ids[off:])
            if off + m == ids.shape[0] and m <= child.key.shape[0]:
                child.last_used = self._tick
                break  # fully covered by this edge (maybe a prefix of it)
            if m == child.key.shape[0]:
                off += m
                # the block CURSOR advances by the edge's block count —
                # never len(child.blocks), which is 0 for a host-demoted
                # node (a cold insert walking through one would hand the
                # tail node blocks belonging to earlier tokens)
                bi += m // bs
                child.last_used = self._tick
                node = child
                continue
            # diverged mid-edge: split at the block boundary if possible.
            # A pinned edge splits safely — the bottom node keeps the
            # refs the live RadixRefs hold, and _candidates/_drop protect
            # the unpinned top through its pinned descendant — so only a
            # sub-block divergence or an immutable on-disk edge bails.
            mb = (m // bs) * bs
            if mb == 0 or child.disk_entry is not None:
                break
            self._split(child, mb)
            # loop re-enters at the (new) top node: ids[off + mb] now
            # diverges from its remaining children → fresh leaf next pass
            continue
        return consumed

    def _split(self, child: RadixNode, at_tokens: int) -> None:
        """Split ``child``'s edge at a block boundary: a new TOP node takes
        the first ``at_tokens`` tokens/blocks, ``child`` keeps the rest as
        the top's only child. Host-tier KV splits along the block axis."""
        bs = self.block_size
        nb = at_tokens // bs
        parent = child.parent
        top = RadixNode(child.key[:at_tokens], child.blocks[:nb], parent)
        top.last_used = child.last_used
        if child.host_kv is not None:
            top.host_kv = tuple(a[:, :, :nb] for a in child.host_kv)
            top.blocks = []
            child.host_kv = tuple(a[:, :, nb:] for a in child.host_kv)
            if child.host_owners is not None:
                top.host_owners = child.host_owners[:nb]
                child.host_owners = child.host_owners[nb:]
        else:
            child.blocks = child.blocks[nb:]
        child.key = child.key[at_tokens:]
        child.parent = top
        top.children[int(child.key[0])] = child
        parent.children[int(top.key[0])] = top
        # the index gains a boundary entry at the new (shallower) depth
        self._publish(top, top.tier())

    # ----------------------------------------------------------- eviction

    def evictable_blocks(self) -> int:
        """Device blocks the cache could free RIGHT NOW (refcount-0
        subtrees — the admission gate adds this to ``alloc.num_free`` when
        sizing a wave, so a full-looking pool with a cold cache still
        admits)."""
        total, cold = 0, {}
        for n in self._post_order():
            cold[n] = n.refs == 0 and all(cold[c] for c in n.children.values())
            if cold[n] and n is not self.root and n.on_device():
                total += len(n.blocks)
        return total

    def _post_order(self) -> list:
        """Every node, the root last, each after its children, in the order
        the JAX tree's recursive walks visit them. Iterative: a recursive
        closure is a reference cycle that would keep the cache (and, through
        its callbacks, the arena) alive until the garbage collector runs."""
        out, stack = [], [(self.root, iter(self.root.children.values()))]
        while stack:
            node, it = stack[-1]
            child = next(it, None)
            if child is None:
                stack.pop()
                out.append(node)
            else:
                stack.append((child, iter(child.children.values())))
        return out

    def _candidates(self) -> list:
        """Evictable-now nodes (cold subtree, device-resident, no device
        children — deepest first by construction), LRU order."""
        out, seen = [], {}
        for n in self._post_order():
            kids = n.children.values()
            cold = n.refs == 0 and all(seen[c][0] for c in kids)
            dev_child = any(seen[c][1] or c.on_device() for c in kids)
            seen[n] = (cold, dev_child)
            if cold and n is not self.root and n.on_device() and not dev_child:
                out.append(n)
        out.sort(key=lambda n: n.last_used)
        return out

    def ensure_free(self, n: int) -> bool:
        """Evict cold nodes (LRU) until the allocator has ``n`` free
        blocks. True on success; False when everything left is pinned —
        the caller falls back to its normal exhaustion handling (queue
        wait / typed error).

        The candidate list is built once and CONSUMED (re-walked only when
        it empties — evicting a leaf can make its parent newly eligible);
        a full tree walk + sort per evicted node would be quadratic host
        work under the server mutex exactly when the cache is loaded."""
        cands: list = []
        exhausted = False
        while self.alloc.num_free < n:
            while cands:
                node = cands.pop(0)
                # pins cannot change mid-call (single-threaded under the
                # server mutex) but an earlier eviction's subtree drop can
                # have detached a listed node
                if node.parent is not None and node.on_device():
                    self._evict(node)
                    exhausted = False
                    break
            else:
                if exhausted:
                    return False
                cands = self._candidates()
                exhausted = True
        return True

    def _evict(self, node: RadixNode) -> None:
        """Free one cold node's device blocks: demote to the host pool
        when tiering is on and room can be made (spilling LRU childless
        host nodes down to the disk pool when one is configured, else
        dropping them), else drop the node (plus any host-tier
        descendants it strands)."""
        nb = len(node.blocks)
        if self.host_pool_blocks:
            # make pool room from the coldest childless host nodes
            # (one walk+sort per _evict call, consumed as needed)
            host_leaves: Optional[list] = None
            while self.host_blocks + nb > self.host_pool_blocks:
                if host_leaves is None:
                    host_leaves = sorted(
                        (
                            c for c in self._iter_nodes()
                            # refs == 0: a pinned host node is mid-restore
                            # by take() — dropping it here would
                            # double-free its pool accounting and strand
                            # its incoming blocks
                            if c.host_kv is not None and not c.children
                            and c.refs == 0
                        ),
                        key=lambda c: c.last_used,
                    )
                if not host_leaves:
                    break
                leaf = host_leaves.pop(0)
                # next rung of the ladder: spill to disk before dropping
                if not (
                    self.disk_pool_blocks and self._demote_to_disk(leaf)
                ):
                    self._drop(leaf)
            if self.host_blocks + nb <= self.host_pool_blocks:
                node.host_kv = tuple(
                    np.asarray(a) for a in self.read_kv(node.blocks)
                )
                if self.block_owner is not None:
                    node.host_owners = [
                        int(self.block_owner(b)) for b in node.blocks
                    ]
                self.alloc.unmark_cached(node.blocks)
                self.alloc.free(node.blocks)
                node.blocks = []
                self.device_blocks -= nb
                self.host_blocks += nb
                self.evictions_to_host += 1
                self._publish(node, "host")
                return
        self._drop_subtree(node)

    def _restore(self, node: RadixNode) -> bool:
        """Stream a demoted node back to device: allocate fresh blocks
        (evicting other cold nodes if needed), write the host copies back
        (bit-exact — same bytes out as in). A disk-tier node stages
        through host RAM first (disk→host→arena): its entry files are
        memory-mapped, CRC-checked and materialized, and a corrupt or
        missing entry DROPS the node's subtree so the caller truncates
        the match and the row re-prefills (containment — never an error
        upward). False when the pool cannot free enough even after
        eviction; a disk node stays on disk in that case (retryable)."""
        from_disk = node.disk_entry is not None
        if from_disk:
            kv = self._read_disk_entry(node.disk_entry, node)
            if kv is None:
                self.disk_corrupt_dropped += 1
                # descendants of a disk node can hold no refs (a pinned
                # node implies a device-resident path through here), so
                # the subtree drop is safe; our caller's provisional pin
                # on this node is released by take()'s truncation
                self._drop_subtree(node)
                return False
        else:
            kv = node.host_kv
        nb = kv[0].shape[2]
        if not self.ensure_free(nb):
            return False
        try:
            blocks = self.alloc.alloc(nb)
        except BlockExhausted:  # raced pinned-only pool state
            return False
        self.write_kv(blocks, *kv)
        self.alloc.mark_cached(blocks)
        node.blocks = blocks
        node.host_kv = None
        node.host_owners = None
        if from_disk:
            # promoted: the KV lives in the arena again, the entry files
            # are done (a later demotion writes a fresh entry)
            self._unlink_entry(node.disk_entry)
            node.disk_entry = None
            self.disk_blocks -= nb
            self.disk_hit_tokens += int(node.key.shape[0])
        else:
            self.host_blocks -= nb
            self.host_hit_tokens += int(node.key.shape[0])
        self.device_blocks += nb
        self._publish(node, "hbm")
        return True

    def _drop(self, node: RadixNode) -> None:
        """Remove one CHILDLESS node from the tree, returning device
        blocks to the allocator / host blocks to the pool / disk blocks
        to the on-disk pool (entry files unlinked)."""
        if node.children:
            raise AssertionError("drop of a node with children")
        prefix = (
            self._prefix_of(node) if self.publish is not None else None
        )
        if node.on_device():
            self.alloc.unmark_cached(node.blocks)
            self.alloc.free(node.blocks)
            self.device_blocks -= len(node.blocks)
        elif node.disk_entry is not None:
            self._unlink_entry(node.disk_entry)
            self.disk_blocks -= int(node.key.shape[0]) // self.block_size
        else:
            self.host_blocks -= int(node.key.shape[0]) // self.block_size
        self.evictions_dropped += 1
        del node.parent.children[int(node.key[0])]
        node.parent = None
        node.blocks = []  # a stale reference must never resurrect freed ids
        node.host_kv = None
        node.host_owners = None
        node.disk_entry = None
        if prefix is not None:
            self._publish(node, None, prefix=prefix)

    def _drop_subtree(self, node: RadixNode) -> None:
        for c in list(node.children.values()):
            self._drop_subtree(c)
        self._drop(node)

    def demote_all(self, *, to_disk: bool = False) -> int:
        """Push every cold device-resident node to the host tier (tests /
        bench: deterministic tier exercise without fabricating allocator
        pressure); with ``to_disk`` every cold host-parked node then
        spills on to the disk pool. Returns nodes demoted."""
        if not self.host_pool_blocks:
            raise ValueError("demote_all needs a host tier")
        if to_disk and not self.disk_pool_blocks:
            raise ValueError("demote_all(to_disk=True) needs a disk tier")
        moved = 0
        while True:
            cands = self._candidates()
            if not cands:
                break
            before = self.evictions_to_host
            self._evict(cands[0])
            moved += self.evictions_to_host - before
        if to_disk:
            for n in list(self._iter_nodes()):
                if n.host_kv is not None and n.refs == 0:
                    if self._demote_to_disk(n):
                        moved += 1
        return moved

    def drop_all(self) -> None:
        """Free every unpinned node (both tiers): the operator's cache
        flush. Pinned paths stay (live rows depend on them)."""
        while True:
            dropped = False
            for n in list(self._iter_nodes()):
                if n.refs == 0 and not n.children:
                    self._drop(n)
                    dropped = True
            if not dropped:
                return

    # ---------------------------------------------------------- disk tier

    def _entry_base(self, entry: str) -> str:
        return os.path.join(self.disk_pool_dir, entry)

    @staticmethod
    def _fsync_dir(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def _unlink_entry(self, entry: str) -> None:
        """Best-effort removal of one entry's files (kv components, meta,
        stray tmps). Failure is ignored — an orphaned file is garbage the
        next ``adopt_pool`` sweeps, never a correctness problem."""
        try:
            names = os.listdir(self.disk_pool_dir)
        except OSError:
            return
        for fn in names:
            if fn.startswith(f"{entry}.json") or fn.startswith(f"{entry}.kv"):
                try:
                    os.unlink(os.path.join(self.disk_pool_dir, fn))
                except OSError:
                    pass

    def _write_disk_entry(self, node: RadixNode) -> Optional[str]:
        """Persist one host-parked node as a pool entry. Each component
        is an ``.npy`` written via fsync'd tmp+rename (mmap-loadable);
        the meta JSON — token prefix, shard owners, per-component CRCs —
        lands LAST, so its presence is the entry's validity marker (the
        same write discipline as ``save_snapshot``). None on I/O failure
        (partial files are cleaned up best-effort)."""
        entry = f"e{self._entry_seq}"
        self._entry_seq += 1
        base = self._entry_base(entry)
        prefix = self._prefix_of(node)
        try:
            crcs = []
            dtypes = []
            for j, a in enumerate(node.host_kv):
                a = np.ascontiguousarray(a)
                crcs.append(zlib.crc32(a.tobytes()))
                dtypes.append(str(a.dtype))
                tmp = f"{base}.kv{j}.npy.tmp"
                with open(tmp, "wb") as f:
                    # raw byte view: np.save round-trips EXTENSION dtypes
                    # (bfloat16, fp8) as raw void ('|V2'), which poisons
                    # the eventual arena write — the dtype name rides the
                    # meta instead and the read side views the bytes back
                    np.save(f, a.view(np.uint8))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, f"{base}.kv{j}.npy")
            meta = {
                "entry": entry,
                "prefix": [int(t) for t in prefix],
                "edge": int(node.key.shape[0]),
                "comps": len(node.host_kv),
                "crc": crcs,
                "dtypes": dtypes,
                "owners": (
                    None if node.host_owners is None
                    else [int(s) for s in node.host_owners]
                ),
            }
            tmp = f"{base}.json.tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, f"{base}.json")
            self._fsync_dir(self.disk_pool_dir)
        except (OSError, ValueError):
            self._unlink_entry(entry)
            return None
        return entry

    def _read_disk_entry(
        self, entry: str, node: RadixNode
    ) -> Optional[tuple]:
        """Load one entry's KV components (``np.load`` memory-mapped,
        then CRC-verified and materialized for the arena write). None on
        any corruption: missing/unparseable meta, missing component,
        CRC or block-count mismatch."""
        base = self._entry_base(entry)
        try:
            with open(f"{base}.json") as f:
                meta = json.load(f)
            parts = []
            for j in range(int(meta["comps"])):
                mm = np.load(f"{base}.kv{j}.npy", mmap_mode="r")
                a = np.ascontiguousarray(mm)
                if zlib.crc32(a.tobytes()) != int(meta["crc"][j]):
                    return None
                parts.append(a.view(self._np_dtype(meta["dtypes"][j])))
            nb = int(node.key.shape[0]) // self.block_size
            if parts[0].shape[2] != nb:
                return None
        except (OSError, ValueError, KeyError, IndexError,
                TypeError, AttributeError):
            return None
        return tuple(parts)

    @staticmethod
    def _np_dtype(name: str) -> np.dtype:
        """Resolve a stored dtype name. The extension types numpy does not
        know ('bfloat16', 'float8_*') resolve to their raw views
        (``uint16`` / ``uint8``), the form the port's host copies take,
        whether or not some other import taught numpy their names."""
        return np.dtype(_RAW_VIEWS.get(name, name))

    def _demote_to_disk(self, node: RadixNode) -> bool:
        """Spill one cold host-parked node to the disk pool, making room
        by dropping the coldest childless disk leaves first. The node
        keeps its ``host_owners`` shard tags (they ride the entry meta
        too, so the provenance survives a restart). False when the pool
        cannot make room or the entry write fails — the caller drops the
        node instead."""
        nb = int(node.key.shape[0]) // self.block_size
        if nb > self.disk_pool_blocks:
            return False
        disk_leaves: Optional[list] = None
        while self.disk_blocks + nb > self.disk_pool_blocks:
            if disk_leaves is None:
                disk_leaves = sorted(
                    (
                        c for c in self._iter_nodes()
                        if c.disk_entry is not None and not c.children
                        and c.refs == 0
                    ),
                    key=lambda c: c.last_used,
                )
            if not disk_leaves:
                return False
            leaf = disk_leaves.pop(0)
            if leaf.parent is not None:  # not detached by an earlier drop
                self._drop(leaf)
        entry = self._write_disk_entry(node)
        if entry is None:
            return False
        node.disk_entry = entry
        node.host_kv = None
        self.host_blocks -= nb
        self.disk_blocks += nb
        self.evictions_to_disk += 1
        self._publish(node, "disk")
        return True

    def adopt_pool(self) -> int:
        """Rebuild disk-tier nodes from the entries already in the pool
        dir — the fresh-start path that makes the pool a persistent
        artifact (``restore`` handles the snapshot path instead). Entries
        adopt parent-first (shorter prefixes first); an entry whose
        parent chain is not fully on disk any more, whose slot is taken,
        or which no longer fits the pool cap is unlinked (a re-prefill
        re-creates it — never an error). Orphan files with no meta (a
        crash mid-spill) are swept. Returns entries adopted."""
        if not self.disk_pool_blocks:
            return 0
        bs = self.block_size
        metas, valid = [], set()
        for fn in sorted(os.listdir(self.disk_pool_dir)):
            m = re.match(r"(e\d+)\.json$", fn)
            if not m:
                continue
            try:
                with open(os.path.join(self.disk_pool_dir, fn)) as f:
                    meta = json.load(f)
                if meta["entry"] != m.group(1) or int(meta["edge"]) % bs:
                    raise ValueError("inconsistent entry meta")
            except (OSError, ValueError, KeyError):
                self._unlink_entry(m.group(1))
                continue
            metas.append(meta)
            valid.add(meta["entry"])
        # sweep orphans: kv/tmp files whose meta never landed
        for fn in os.listdir(self.disk_pool_dir):
            m = re.match(r"(e\d+)\.", fn)
            if m and m.group(1) not in valid and not fn.endswith(".json"):
                try:
                    os.unlink(os.path.join(self.disk_pool_dir, fn))
                except OSError:
                    pass
        metas.sort(key=lambda m: len(m["prefix"]))
        adopted = 0
        for meta in metas:
            prefix = np.asarray(meta["prefix"], np.int32)
            edge = int(meta["edge"])
            nb = edge // bs
            plen = int(prefix.shape[0]) - edge
            node, off, ok = self.root, 0, plen >= 0 and edge > 0
            while ok and off < plen:
                child = node.children.get(int(prefix[off]))
                L = 0 if child is None else int(child.key.shape[0])
                if (
                    child is None or L > plen - off
                    or not np.array_equal(child.key, prefix[off:off + L])
                ):
                    ok = False
                    break
                off += L
                node = child
            if (
                not ok or off != plen
                or int(prefix[plen]) in node.children
                or self.disk_blocks + nb > self.disk_pool_blocks
            ):
                self._unlink_entry(meta["entry"])
                continue
            n = RadixNode(prefix[plen:], [], node)
            n.disk_entry = meta["entry"]
            n.host_owners = (
                None if meta.get("owners") is None
                else [int(s) for s in meta["owners"]]
            )
            node.children[int(prefix[plen])] = n
            self.disk_blocks += nb
            adopted += 1
            self._publish(n, "disk")
        return adopted

    # ----------------------------------------------------- cluster index

    def _prefix_of(self, node: RadixNode) -> np.ndarray:
        """Full root-path token prefix through ``node`` (its edge last)."""
        parts, n = [], node
        while n is not None and n.parent is not None:
            parts.append(n.key)
            n = n.parent
        if not parts:
            return np.zeros((0,), np.int32)
        parts.reverse()
        return np.concatenate(parts)

    def announce_all(self) -> int:
        """(Re-)publish every node's current tier — called after the
        owner wires ``publish`` onto a tree that already has contents
        (snapshot restore, adopted pool, late index attach) so the
        cluster index converges without waiting for traffic. Returns
        nodes announced."""
        n = 0
        for node in self._iter_nodes():
            self._publish(node, node.tier())
            n += 1
        return n

    def _publish(
        self, node: RadixNode, tier: Optional[str],
        prefix: Optional[np.ndarray] = None,
    ) -> None:
        """Mirror one tier transition into the cluster index (tier None
        = removed). Best-effort: a publisher fault must never fail the
        cache operation it rides on."""
        if self.publish is None:
            return
        try:
            p = self._prefix_of(node) if prefix is None else prefix
            self.publish(p, tier)
        except Exception:
            pass

    # -------------------------------------------------------- maintenance

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def stats(self) -> dict:
        elig = self.eligible_tokens
        return {
            "hit_tokens": self.hit_tokens,
            "eligible_tokens": elig,
            "hit_rate": (self.hit_tokens / elig) if elig else 0.0,
            "host_hit_tokens": self.host_hit_tokens,
            "disk_hit_tokens": self.disk_hit_tokens,
            "device_blocks": self.device_blocks,
            "host_blocks": self.host_blocks,
            "host_pool_blocks": self.host_pool_blocks,
            "disk_blocks": self.disk_blocks,
            "disk_pool_blocks": self.disk_pool_blocks,
            "nodes": sum(1 for _ in self._iter_nodes()),
            "evictions_to_host": self.evictions_to_host,
            "evictions_to_disk": self.evictions_to_disk,
            "evictions_dropped": self.evictions_dropped,
            "disk_corrupt_dropped": self.disk_corrupt_dropped,
        }

    def check(self) -> None:
        """Tree invariant for the chaos suites: block-aligned edges, one
        backing tier per node, counters that re-add, every device block
        cache-marked and refcounted in the allocator."""
        bs = self.block_size
        dev = host = disk = 0
        for n in self._iter_nodes():
            L = n.key.shape[0]
            if L == 0 or L % bs:
                raise AssertionError(f"edge length {L} not block-aligned")
            if n.refs < 0:
                raise AssertionError("negative node refcount")
            if n.parent.children.get(int(n.key[0])) is not n:
                raise AssertionError("parent/child link broken")
            if n.host_kv is not None and n.disk_entry is not None:
                raise AssertionError("node backed by two demoted tiers")
            if n.on_device():
                if len(n.blocks) != L // bs:
                    raise AssertionError(
                        f"{len(n.blocks)} blocks for {L} tokens"
                    )
                for b in n.blocks:
                    if self.alloc._ref[b] < 1 or not self.alloc._cached[b]:
                        raise AssertionError(
                            f"tree block {b} not allocator-backed/marked"
                        )
                dev += len(n.blocks)
            elif n.disk_entry is not None:
                if n.blocks:
                    raise AssertionError("disk node still holds device ids")
                disk += L // bs
            else:
                if n.blocks:
                    raise AssertionError("host node still holds device ids")
                if n.host_kv[0].shape[2] != L // bs:
                    raise AssertionError("host KV block count mismatch")
                host += L // bs
        if (
            dev != self.device_blocks or host != self.host_blocks
            or disk != self.disk_blocks
        ):
            raise AssertionError(
                f"counter drift: dev {dev} vs {self.device_blocks}, "
                f"host {host} vs {self.host_blocks}, "
                f"disk {disk} vs {self.disk_blocks}"
            )
        if self.host_blocks > self.host_pool_blocks:
            raise AssertionError("host pool over its cap")
        if self.disk_blocks > self.disk_pool_blocks:
            raise AssertionError("disk pool over its cap")

    # ----------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """Host-serializable tree: node metadata + a flat array dict
        (edge keys; host-tier K/V). Node refs are NOT stored — restore
        re-pins from the restored rows' matches."""
        nodes, arrays = [], {}
        index = {self.root: -1}
        order = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                index[c] = len(order)
                order.append(c)
                stack.append(c)
        for i, n in enumerate(order):
            meta = {
                "parent": index[n.parent],
                "blocks": [int(b) for b in n.blocks],
                "tier": n.tier(),
                "last_used": int(n.last_used),
            }
            if n.host_owners is not None:
                # the shard-tagged layout survives the checkpoint so a
                # restored cp server keeps the demote-time provenance
                meta["owners"] = [int(s) for s in n.host_owners]
            if n.disk_entry is not None:
                # a disk node rides as a REFERENCE to its pool
                # entry — the pool itself is the persistent artifact, so
                # the snapshot never inlines spilled KV
                meta["entry"] = n.disk_entry
            nodes.append(meta)
            arrays[f"radix.{i}.key"] = np.asarray(n.key, np.int32)
            if n.host_kv is not None:
                # one entry per host-KV component — kv0/kv1 are K and V,
                # quantized arenas add kv2/kv3 (the scale arenas)
                for j, a in enumerate(n.host_kv):
                    arrays[f"radix.{i}.kv{j}"] = a
        return {
            "nodes": nodes,
            "arrays": arrays,
            "counters": {
                "hit_tokens": self.hit_tokens,
                "eligible_tokens": self.eligible_tokens,
                "host_hit_tokens": self.host_hit_tokens,
                "disk_hit_tokens": self.disk_hit_tokens,
            },
        }

    def restore(self, snap: dict, arrays: dict) -> None:
        """Rebuild the tree on a fresh cache whose allocator was already
        ``restore``d with the device-tier nodes' blocks as owners. Marks
        device blocks cache-held and recounts both tiers."""
        if self.device_blocks or self.host_blocks:
            raise ValueError("restore on a non-empty radix cache")
        if self.disk_blocks:
            # an adopted pool yields to the snapshot (which references the
            # same entries): detach the adopted nodes WITHOUT touching the
            # files the snapshot keeps, unlink the ones it doesn't
            keep = {
                m["entry"] for m in snap["nodes"] if m.get("entry")
            }
            for n in list(self._iter_nodes()):
                if n.disk_entry is not None and n.disk_entry not in keep:
                    self._unlink_entry(n.disk_entry)
            self.root.children = {}
            self.disk_blocks = 0
        order: list[RadixNode] = []
        for i, meta in enumerate(snap["nodes"]):
            parent = (
                self.root if meta["parent"] == -1 else order[meta["parent"]]
            )
            key = np.asarray(arrays[f"radix.{i}.key"], np.int32)
            node = RadixNode(key, meta["blocks"], parent)
            node.last_used = int(meta["last_used"])
            if meta["tier"] == "disk":
                node.blocks = []
                node.disk_entry = meta["entry"]
                node.host_owners = (
                    None if meta.get("owners") is None
                    else [int(s) for s in meta["owners"]]
                )
                self.disk_blocks += key.shape[0] // self.block_size
            elif meta["tier"] == "host":
                if f"radix.{i}.kv0" in arrays:
                    parts = []
                    while f"radix.{i}.kv{len(parts)}" in arrays:
                        parts.append(
                            np.asarray(arrays[f"radix.{i}.kv{len(parts)}"])
                        )
                    node.host_kv = tuple(parts)
                else:  # pre-kv-quant (format-3) snapshot keys
                    node.host_kv = (
                        np.asarray(arrays[f"radix.{i}.k"]),
                        np.asarray(arrays[f"radix.{i}.v"]),
                    )
                node.blocks = []
                node.host_owners = (
                    None if meta.get("owners") is None
                    else [int(s) for s in meta["owners"]]
                )
                self.host_blocks += key.shape[0] // self.block_size
            else:
                self.alloc.mark_cached(node.blocks)
                self.device_blocks += len(node.blocks)
            parent.children[int(key[0])] = node
            order.append(node)
            self._tick = max(self._tick, node.last_used)
        c = snap.get("counters", {})
        self.hit_tokens = int(c.get("hit_tokens", 0))
        self.eligible_tokens = int(c.get("eligible_tokens", 0))
        self.host_hit_tokens = int(c.get("host_hit_tokens", 0))
        self.disk_hit_tokens = int(c.get("disk_hit_tokens", 0))
        for node in order:
            # a restored replica re-announces its whole tree so the
            # cluster index converges without waiting for traffic
            self._publish(node, node.tier())
