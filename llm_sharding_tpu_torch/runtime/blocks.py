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
cache's (``runtime/radix.py``). ``ShardedBlockAllocator`` is the
context-parallel pool (``blocks.py:240``): per-shard free lists over
global block ids, its ``alloc_at`` striping a row's blocks over the shards.
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

    def alloc_at(self, start_col: int, n: int) -> list[int]:
        """``alloc`` with a placement hint (``blocks.py:158``): ``start_col``
        is the first logical column, in blocks, the run will map. One pool
        has no placement to prefer; ``ShardedBlockAllocator`` stripes."""
        return self.alloc(n)

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


class ShardedBlockAllocator(BlockAllocator):
    """Per-shard free lists over one global block id space, the host half
    of context-parallel paged serving (``serve(cp=N)``; JAX
    ``blocks.py:240-460``).

    Global id ``gid = shard * blocks_per_shard + local``: shard ``gid //
    blocks_per_shard`` holds the block at local id ``gid %
    blocks_per_shard`` of its own arena. The server's host table keeps
    global ids and projects each shard's plane of local ids when it pushes
    them (a column another shard owns maps to the local trash block 0).
    Every shard's local block 0 (gid ``s * blocks_per_shard``) is that
    shard's trash, pinned as the base pool's block 0 is.

    ``alloc_at`` stripes ownership round-robin by logical column, falling
    back to the most-free shard when the preferred one is dry, so the total
    free count (``num_free``) stays a sufficient admission bound. The base
    class's flat free list is kept as a view of the per-shard lists, so
    ``num_free``, ``in_use`` and the KV gauges read it unchanged."""

    def __init__(self, shards: int, blocks_per_shard: int, block_size: int):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if blocks_per_shard < 2:
            raise ValueError(
                f"blocks_per_shard must be >= 2 (each shard's local block "
                f"0 is its reserved trash sink), got {blocks_per_shard}"
            )
        super().__init__(shards * blocks_per_shard, block_size)
        self.shards = shards
        self.blocks_per_shard = blocks_per_shard
        for s in range(1, shards):
            self._ref[s * blocks_per_shard] = 1  # each shard's trash, pinned
        self._shard_free: list[list[int]] = [
            list(range((s + 1) * blocks_per_shard - 1, s * blocks_per_shard, -1))
            for s in range(shards)
        ]
        self._sync_free()

    def _sync_free(self) -> None:
        # the per-shard lists are the truth; the flat list is their view
        self._free = [b for fl in self._shard_free for b in fl]

    def owner(self, gid: int) -> int:
        """The shard that holds global block ``gid``."""
        return int(gid) // self.blocks_per_shard

    def owner_shards(self, blocks) -> list[int]:
        """The distinct shards that hold ``blocks``, in order: the
        per-shard passes of a block stream (snapshot, hand-off, host-tier
        demote and restore), and the keys of its ``cp_shard_stream``
        fault probe."""
        return sorted({self.owner(b) for b in blocks})

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks: each shard keeps its local block 0."""
        return self.shards * (self.blocks_per_shard - 1)

    def _take(self, shard: int) -> int:
        b = self._shard_free[shard].pop()
        self._ref[b] = 1
        return b

    def _most_free(self) -> int:
        return max(range(self.shards), key=lambda i: len(self._shard_free[i]))

    def _check_free(self, n: int, what: str) -> None:
        if n < 0:
            raise ValueError(what)
        if n > self.num_free:
            raise BlockExhausted(
                f"need {n} KV blocks, {self.num_free} free "
                f"(of {self.capacity_blocks} across {self.shards} shards)"
            )

    def alloc(self, n: int) -> list[int]:
        """``n`` blocks with no placement (a radix restore, a hand-off's
        landing): each from the most-free shard."""
        self._check_free(n, f"alloc({n})")
        taken = [self._take(self._most_free()) for _ in range(n)]
        self._sync_free()
        return taken

    def alloc_at(self, start_col: int, n: int) -> list[int]:
        """Block ``j`` of the run (logical column block ``start_col + j``)
        from shard ``(start_col + j) % shards``, or the most-free shard when
        that one has none: a row's KV, and with it each decode step's write
        and each chunk's columns, spreads over the shards."""
        self._check_free(n, f"alloc_at({start_col}, {n})")
        taken = []
        for j in range(n):
            s = (int(start_col) + j) % self.shards
            taken.append(self._take(s if self._shard_free[s] else self._most_free()))
        self._sync_free()
        return taken

    def _refuse_trash(self, blocks, what: str) -> None:
        for b in blocks:
            if int(b) % self.blocks_per_shard == 0:
                raise ValueError(f"{what} of reserved trash block {int(b)}")

    def share(self, blocks) -> None:
        self._refuse_trash(blocks, "share")
        super().share(blocks)

    def mark_cached(self, blocks) -> None:
        self._refuse_trash(blocks, "mark_cached")
        super().mark_cached(blocks)

    def free(self, blocks) -> None:
        for b in blocks:
            b = int(b)
            if b % self.blocks_per_shard == 0:
                raise ValueError("free of a reserved trash block")
            if self._ref[b] < 1:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._shard_free[b // self.blocks_per_shard].append(b)
        self._sync_free()

    def restore(self, private_rows, shared_rows) -> None:
        super().restore(private_rows, shared_rows)
        self._shard_free = [
            sorted((b for b in self._free if b // self.blocks_per_shard == s), reverse=True)
            for s in range(self.shards)
        ]
        self._sync_free()

    def check(self) -> None:
        """The base invariant per shard: the free lists and the held blocks
        partition the pool, every shard's trash pinned and never cached,
        and each free entry filed under its own shard."""
        NB = self.blocks_per_shard
        flat = [b for fl in self._shard_free for b in fl]
        if sorted(flat) != sorted(self._free):
            raise AssertionError("per-shard free lists drifted from the flat view")
        if len(set(flat)) != len(flat):
            raise AssertionError(f"free list has duplicates: {flat}")
        for s in range(self.shards):
            if self._ref[s * NB] != 1:
                raise AssertionError(f"shard {s} trash refcount must stay pinned at 1")
            if self._cached[s * NB]:
                raise AssertionError(f"shard {s} trash block cache-marked")
            for b in self._shard_free[s]:
                if b // NB != s or b % NB == 0:
                    raise AssertionError(f"free-list entry {b} misfiled under shard {s}")
                if self._ref[b] != 0:
                    raise AssertionError(f"free block {b} has refcount {self._ref[b]}")
                if self._cached[b]:
                    raise AssertionError(f"free block {b} still cache-marked")
        held = [b for b in range(self.num_blocks) if b % NB != 0 and self._ref[b] > 0]
        if len(held) + len(flat) != self.capacity_blocks:
            raise AssertionError(
                f"{len(held)} held + {len(flat)} free != {self.capacity_blocks} blocks"
            )
