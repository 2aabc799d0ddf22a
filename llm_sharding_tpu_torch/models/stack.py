"""The layer loops shared by the model families (counterpart of
``llm_sharding_tpu/models/stack.py:24-134``).

The JAX package scans layer-stacked parameters with ``lax.scan`` and
threads the cache through the carry. The port keeps parameters as a list
of per-layer dicts and loops in Python; each layer updates its slice of
the cache (or its arena) in place.

``layer_mask`` (bool ``[L]``, from ``shard_store.load_stage(pad_to=)``)
marks the real layers of a stage padded to a common depth: a masked layer
leaves the hidden state and the KV as they were. The gate is a select on
the device, as in the JAX package: never a multiply (which would carry a
masked layer's non-finite output through) and never a host read.

Tensor parallelism (``parallel/tensor.py``) runs a layer over a tensor
group: its parameters are ``Shards``, one megatron slice per shard, and
its KV is ``HeadShards``, one contiguous tensor of ``Nkv / tp`` heads per
shard. ``per_shard`` binds a shard's attention to its own KV, and
``tp_reduce`` sums the row-parallel partials, where the JAX package's
block ``psum``s over the tensor axis. With plain parameters and tensors
every helper reduces to the one-device call.

Context-parallel serving (``serve(cp=N)``) splits a paged arena by BLOCK
over a shard group: its KV (and scales, and the block table it is read
through) are ``CpShards``, one whole arena of ``kv_blocks`` blocks per
shard, each read through the shard's own table of local block ids.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import hop
from .cache import KVCache


class Shards(tuple):
    """Per-shard values of one tensor group (a layer's parameter dicts,
    the attention of each shard): shard ``j``'s value lives on
    ``devices[j]``."""

    def __new__(cls, values, devices):
        self = super().__new__(cls, values)
        self.devices = tuple(devices)
        return self


class HeadShards:
    """A KV tensor split by KV head over a tensor group: ``parts[j]`` is a
    contiguous tensor of the heads ``[j, j + 1) * Nkv / tp`` on
    ``devices[j]``. Indexing that leaves the last two axes (heads, head
    dim) whole applies to every part; a plain tensor assigned to it is
    split by head. ``shape`` is the whole tensor's; ``device`` the first
    part's."""

    def __init__(self, parts, devices=None):
        self.parts = list(parts)
        self.devices = tuple(devices or (p.device for p in self.parts))

    def _index(self, idx, dev):
        if isinstance(idx, tuple):
            return tuple(self._index(i, dev) for i in idx)
        return hop(idx, dev) if isinstance(idx, torch.Tensor) else idx

    def __getitem__(self, idx) -> "HeadShards":
        return HeadShards([p[self._index(idx, d)] for p, d in zip(self.parts, self.devices)],
                          self.devices)

    def __setitem__(self, idx, value) -> None:
        if isinstance(value, HeadShards):
            vals = value.parts
        elif isinstance(value, torch.Tensor) and value.dim() >= 2:
            vals = value.chunk(len(self.parts), dim=-2)
        else:
            vals = [value] * len(self.parts)
        for p, d, v in zip(self.parts, self.devices, vals):
            p[self._index(idx, d)] = hop(v, d) if isinstance(v, torch.Tensor) else v

    def to(self, dtype) -> "HeadShards":
        return HeadShards([p.to(dtype) for p in self.parts], self.devices)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, heads joined in shard order, on ``device``
        (default the first part's)."""
        dev = device or self.devices[0]
        return torch.cat([hop(p, dev) for p in self.parts], dim=-2)

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[-2] = sum(p.shape[-2] for p in self.parts)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def element_size(self) -> int:
        return self.parts[0].element_size()


class CpShards:
    """Per-shard tensors of a context-parallel group (``serve(cp=N)``):
    ``parts[s]`` lives on ``devices[s]``. Each part is a whole tensor of
    its shard (an arena of the shard's blocks, its scales, or its plane of
    the block table), so indexing applies to every part alike. ``shape``,
    ``dtype`` and ``device`` are the first part's."""

    def __init__(self, parts, devices=None):
        self.parts = list(parts)
        self.devices = tuple(devices or (p.device for p in self.parts))

    def __getitem__(self, idx) -> "CpShards":
        return CpShards([p[_on(idx, d)] for p, d in zip(self.parts, self.devices)], self.devices)

    def __len__(self) -> int:
        return len(self.parts)

    @property
    def shape(self) -> torch.Size:
        return self.parts[0].shape

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def element_size(self) -> int:
        return self.parts[0].element_size()


def _on(idx, dev):
    """An index with its tensors on ``dev``."""
    if isinstance(idx, tuple):
        return tuple(_on(i, dev) for i in idx)
    return hop(idx, dev) if isinstance(idx, torch.Tensor) else idx


def cp_part(x, s: int):
    """Shard ``s``'s part of a ``CpShards`` (None stays None)."""
    return None if x is None else x.parts[s]


def full_heads(x, device=None):
    """``x`` whole: the parts of a ``HeadShards`` (or the per-shard tensors
    of a ``Shards``) joined by head, a tensor as it is."""
    if isinstance(x, Shards):
        x = HeadShards(list(x), x.devices)
    return x.full(device) if isinstance(x, HeadShards) else x


def per_shard(fn: Callable, *args):
    """``fn(*args)``; where an argument is ``HeadShards`` or ``Shards``,
    once per shard instead, with shard ``j``'s part of each such argument
    and the other tensors on shard ``j``'s device. Returns ``Shards`` of
    the results then."""
    group = next((a for a in args if isinstance(a, (HeadShards, Shards))), None)
    if group is None:
        return fn(*args)
    out = []
    for j, d in enumerate(group.devices):
        out.append(fn(*(
            a.parts[j] if isinstance(a, HeadShards)
            else a[j] if isinstance(a, Shards)
            else hop(a, d) if isinstance(a, torch.Tensor) else a
            for a in args
        )))
    return Shards(out, group.devices)


def replicated(p, key: str):
    """A replicated leaf of a layer's parameters (a tensor group's from
    its first shard), or None where the layer has none."""
    return (p[0] if isinstance(p, Shards) else p).get(key)


#: reduces ``tp_reduce`` has issued, by the process (read and reset by
#: ``reduce_count``); two per layer of a tensor-parallel stage
_REDUCES = [0]


def reduce_count(reset: bool = False) -> int:
    """The reduces issued since the last reset (``reset`` starts anew)."""
    n = _REDUCES[0]
    if reset:
        _REDUCES[0] = 0
    return n


def tp_reduce(p, h: torch.Tensor, fn: Callable) -> torch.Tensor:
    """The sum over a tensor group of ``fn(p_j, h_j, j)``, the row-parallel
    partial of shard ``j`` (``h_j``: ``h`` on its device), the JAX
    ``psum`` over the tensor axis. The partials are summed in shard order,
    in their dtype, on the first shard's device, where the result stays;
    the next ``per_shard`` call copies it to the others. With plain
    parameters: ``fn(p, h, None)``."""
    if not isinstance(p, Shards):
        return fn(p, h, None)
    d0 = p.devices[0]
    acc = None
    for j, (pj, d) in enumerate(zip(p, p.devices)):
        part = hop(fn(pj, hop(h, d), j), d0)
        acc = part if acc is None else acc + part
    _REDUCES[0] += 1
    return acc


def scan_layers(
    layers: list,
    h: torch.Tensor,  # [B, S, H]
    cache: KVCache,
    positions: torch.Tensor,  # [B, S] int32
    apply_layer: Callable,  # (p, h, k_row, v_row, kv_pos, length) -> h
    layer_mask: Optional[torch.Tensor] = None,  # [L] bool
) -> tuple[torch.Tensor, KVCache]:
    """Record this step's key positions once, run every layer over its own
    cache row, advance the shared write offset."""
    S = h.shape[1]
    start = cache.length
    if start + S > cache.capacity:
        raise ValueError(
            f"cache write [{start}, {start + S}) exceeds capacity {cache.capacity}"
        )
    cache.pos[:, start : start + S] = positions
    for i, p in enumerate(layers):
        k_row, v_row = cache.k[i], cache.v[i]
        if layer_mask is None:
            h = apply_layer(p, h, k_row, v_row, cache.pos, start)
            continue
        valid = layer_mask[i]
        fresh = slice(start, start + S)
        old_k, old_v = k_row[:, fresh].clone(), v_row[:, fresh].clone()
        h = torch.where(valid, apply_layer(p, h, k_row, v_row, cache.pos, start), h)
        k_row[:, fresh] = torch.where(valid, k_row[:, fresh], old_k)
        v_row[:, fresh] = torch.where(valid, v_row[:, fresh], old_v)
    cache.length = start + S
    return h, cache


def scan_layers_paged(
    layers: list,
    h: torch.Tensor,  # [B, S, H]
    k_arena: torch.Tensor,  # [L, NB, BS, Nkv, D] pooled per-layer blocks
    v_arena: torch.Tensor,
    apply_layer: Callable,  # (p, valid, h, k_l, v_l, ks_l, vs_l) -> h
    layer_mask: Optional[torch.Tensor] = None,  # [L] bool
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Nkv] f32, quantized arena
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged counterpart of ``scan_layers``: each layer scatters into and
    attends from its arena slice (and scale slice). A masked layer's
    ``valid`` goes INTO ``apply_layer``, which gates its scattered
    entries; the hidden-state gate is here. Key-position bookkeeping
    stays with the caller."""
    for i, p in enumerate(layers):
        valid = None if layer_mask is None else layer_mask[i]
        h_new = apply_layer(
            p, valid, h, k_arena[i], v_arena[i],
            None if k_scale is None else k_scale[i], None if v_scale is None else v_scale[i],
        )
        h = h_new if valid is None else torch.where(valid, h_new, h)
    return h
