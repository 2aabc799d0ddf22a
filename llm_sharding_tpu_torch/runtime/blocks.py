"""Host-side KV block allocator for paged serving: the port's own copy of
``BlockAllocator`` from ``llm_sharding_tpu/runtime/blocks.py:39-237``
(numpy only; the JAX package's copy cannot be imported without jax, as
its ``runtime/__init__.py`` imports the engine).

Block 0 is the trash sink and is never allocated: every unmapped table
entry points at it, and readers gate it to zeros. Freeing a row is two
steps in order: remap its table to trash, then return the blocks.
Blocks are refcounted as in the JAX allocator, which catches double
frees; exhaustion is the typed ``BlockExhausted``, and the server checks
``num_free`` first, so an exhausted pool is a queue wait, never a crash.
``share`` adds a reference to a block another owner holds (a prefix
handle's, or a radix-tree node's, mapped read-only into a row), and the
``_cached`` marks tag the blocks whose owning reference is the prefix
cache's (``runtime/radix.py``). The context-parallel
``ShardedBlockAllocator`` and its ``alloc_at`` placement hint come with
the context-parallel slice.
"""

from __future__ import annotations

import numpy as np

TRASH_BLOCK = 0  # reserved garbage sink; table entries default here


class BlockExhausted(RuntimeError):
    """``alloc`` could not satisfy the request: every non-reserved block is
    held."""


class BlockAllocator:
    """Free list + per-block refcounts over ``num_blocks`` KV blocks of
    ``block_size`` token slots each. Not thread-safe on its own: the owning
    server serializes every call."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block {TRASH_BLOCK} is the "
                f"reserved trash sink), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO: a just-freed block is reused first (a small hot set)
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int32)
        self._ref[TRASH_BLOCK] = 1  # pinned forever
        # blocks whose owning reference is the prefix cache's, not a row's
        self._cached = np.zeros(num_blocks, bool)

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (the trash block never counts)."""
        return self.num_blocks - 1

    def bytes_per_block(
        self, *, num_layers: int, num_kv_heads: int, head_dim: int, kv_dtype,
    ) -> int:
        """Device bytes one arena block costs across all layers
        (``blocks.py:81-96``): K + V codes, ``2 * L * BS * Nkv * D *
        itemsize``, plus for the 1-byte int8/fp8 dtypes the block's slice of
        the f32 scale pools, ``2 * L * Nkv * 4``. At an equal byte budget,
        ``budget // bytes_per_block`` is how many blocks each dtype admits.
        ``kv_dtype`` is the arena's torch dtype."""
        item = kv_dtype.itemsize
        kv = 2 * num_layers * self.block_size * num_kv_heads * head_dim * item
        scales = 2 * num_layers * num_kv_heads * 4 if item == 1 else 0
        return kv + scales

    def arena_bytes(
        self, *, num_layers: int, num_kv_heads: int, head_dim: int, kv_dtype,
    ) -> int:
        """Device bytes of this pool's whole arena, the reserved trash block
        included (``blocks.py:98-108``)."""
        return self.num_blocks * self.bytes_per_block(
            num_layers=num_layers, num_kv_heads=num_kv_heads, head_dim=head_dim,
            kv_dtype=kv_dtype,
        )

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity_blocks - len(self._free)

    @property
    def cache_cold(self) -> int:
        """Cache-held blocks no live row maps (the tree's reference is the
        only one, ``blocks.py:126``): the KV gauges count them as reusable
        capacity, not waste."""
        return int((self._cached & (self._ref == 1)).sum())

    def mark_cached(self, blocks) -> None:
        """Tag allocated blocks as cache-owned (``runtime/radix.py`` calls
        this when a node takes a row's blocks or restores a demoted node)."""
        for b in blocks:
            if self._ref[b] < 1 or b == TRASH_BLOCK:
                raise ValueError(f"mark_cached of unallocated block {b}")
        self._cached[list(blocks)] = True

    def unmark_cached(self, blocks) -> None:
        self._cached[list(blocks)] = False

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks (refcount 1 each); raises ``BlockExhausted``
        without partial allocation when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise BlockExhausted(
                f"need {n} KV blocks, {len(self._free)} free (of {self.capacity_blocks})"
            )
        taken = [self._free.pop() for _ in range(n)]
        self._ref[taken] = 1
        return taken

    def share(self, blocks) -> None:
        """Add a reference to each of ``blocks`` (``blocks.py:166``): a row
        maps an already-allocated block read-only into its table."""
        for b in blocks:
            if self._ref[b] < 1 or b == TRASH_BLOCK:
                raise ValueError(f"share of unallocated/reserved block {b}")
            self._ref[b] += 1

    def free(self, blocks) -> None:
        """Drop one reference per block; a block returns to the free list
        when its last reference drops."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("free of the reserved trash block")
            if self._ref[b] < 1:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(int(b))

    def restore(self, private_rows, shared_rows) -> None:
        """Rebuild allocation state from per-row ownership lists
        (``blocks.py:186``): private blocks get refcount 1, shared blocks
        one reference per row mapping them. Only on a fresh allocator."""
        if self.in_use:
            raise ValueError("restore on a non-empty allocator")
        free = set(self._free)
        for blocks in private_rows:
            for b in blocks:
                if b not in free:
                    raise ValueError(f"snapshot block {b} double-owned or reserved")
                free.discard(b)
                self._ref[b] = 1
        for blocks in shared_rows:
            for b in blocks:
                if b in free:
                    free.discard(b)
                    self._ref[b] = 1
                elif self._ref[b] >= 1:
                    self._ref[b] += 1
                else:
                    raise ValueError(f"snapshot shared block {b} reserved")
        # keep LIFO order deterministic after restore
        self._free = sorted(free, reverse=True)

    def check(self) -> None:
        """Invariant: the free list and the refcounted blocks exactly
        partition the non-reserved pool, with no double entries, and no
        free block is cache-marked."""
        free = self._free
        if len(set(free)) != len(free):
            raise AssertionError(f"free list has duplicates: {free}")
        for b in free:
            if b == TRASH_BLOCK or not (0 < b < self.num_blocks):
                raise AssertionError(f"bad free-list entry {b}")
            if self._ref[b] != 0:
                raise AssertionError(f"free block {b} has refcount {self._ref[b]}")
            if self._cached[b]:
                raise AssertionError(f"free block {b} still cache-marked")
        held = [b for b in range(1, self.num_blocks) if self._ref[b] > 0]
        if len(held) + len(free) != self.capacity_blocks:
            raise AssertionError(
                f"{len(held)} held + {len(free)} free != {self.capacity_blocks} blocks"
            )
        if self._ref[TRASH_BLOCK] != 1:
            raise AssertionError("trash block refcount must stay pinned at 1")
