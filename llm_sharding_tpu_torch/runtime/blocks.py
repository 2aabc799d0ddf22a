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
Block sharing (``share``) and the prefix-cache marks, snapshot
``restore`` and the context-parallel ``ShardedBlockAllocator`` come with
their slices.
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

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (the trash block never counts)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity_blocks - len(self._free)

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

    def check(self) -> None:
        """Invariant: the free list and the refcounted blocks exactly
        partition the non-reserved pool, with no double entries."""
        free = self._free
        if len(set(free)) != len(free):
            raise AssertionError(f"free list has duplicates: {free}")
        for b in free:
            if b == TRASH_BLOCK or not (0 < b < self.num_blocks):
                raise AssertionError(f"bad free-list entry {b}")
            if self._ref[b] != 0:
                raise AssertionError(f"free block {b} has refcount {self._ref[b]}")
        held = [b for b in range(1, self.num_blocks) if self._ref[b] > 0]
        if len(held) + len(free) != self.capacity_blocks:
            raise AssertionError(
                f"{len(held)} held + {len(free)} free != {self.capacity_blocks} blocks"
            )
        if self._ref[TRASH_BLOCK] != 1:
            raise AssertionError("trash block refcount must stay pinned at 1")
