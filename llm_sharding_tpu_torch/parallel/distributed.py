"""Multi-process setup and the stage transport between processes (the port
of ``llm_sharding_tpu/parallel/distributed.py``; ``hybrid_mesh`` is in
``parallel/mesh.py``).

The reference runs one OS process per node, each holding a contiguous
slice of the layers, and passes the hidden state from node to node; the
last node's token goes back to the first (``start_node.py``). The JAX
package forms the cluster with ``jax.distributed.initialize`` and runs one
program over the global mesh. Here each process joins a
``torch.distributed`` group, rank ``i`` holds stage ``i`` of a
``PlacementSpec`` over the ranks, and ``StageTransport`` moves the hidden
state and the token around the ring.

The backend is named by the caller, never picked from what is present.
NCCL does not put two ranks of one group on one GPU, and a one-card
machine runs every rank on the same card, so the ranks there talk over
``gloo``: gloo's ``send`` / ``recv`` take host tensors, so each hop is
staged through pinned host memory (``StageTransport``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import to_device
from ..models.cache import init_cache
from ..models.config import ModelConfig
from ..ops.sampling import is_stop, sample
from .pipeline import model_fns

# the hop stages through host tensors, which NCCL refuses (ROADMAP §B 13)
BACKENDS = ("gloo",)


def initialize_multihost(
    coordinator_address: str, num_processes: int, process_id: int, *, backend: str,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group (JAX ``distributed.py:31-47``): one call per
    process, before any collective. ``coordinator_address`` is ``host:port``
    of rank 0's rendezvous (``tcp://``); ``backend`` ``"gloo"``,
    given explicitly by every rank."""
    import datetime

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def process_local_batch(global_batch: int) -> int:
    """Rows of a data-parallel batch this process feeds (JAX
    ``distributed.py:63-71``): an equal share of ``global_batch``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by process count {n}")
    return global_batch // n


def put_global(arr, device, axis: int = 0) -> torch.Tensor:
    """This process's slice of a host array put on ``device`` (the
    counterpart of JAX ``put_global``, ``distributed.py:74-85``): every
    process holds the whole host array and materializes only its equal
    share along ``axis``, rank ``r`` the ``r``-th."""
    arr = np.asarray(arr)
    n = dist.get_world_size() if dist.is_initialized() else 1
    r = dist.get_rank() if dist.is_initialized() else 0
    if arr.shape[axis] % n != 0:
        raise ValueError(f"axis {axis} of {arr.shape} not divisible by process count {n}")
    part = np.split(arr, n, axis=axis)[r]
    return to_device(np.ascontiguousarray(part), torch.device(device))


class StageTransport:
    """The hops of the ring between ranks: ``send_hidden`` to rank ``i +
    1``, ``recv_hidden`` from rank ``i - 1``, and the last rank's token back
    to rank 0. Each hidden state goes with a header ``[go, S]`` (``go`` 0:
    the ring is done). Over ``gloo`` the tensors cross as host tensors:
    a device tensor is copied into pinned memory first, and a received one
    copied to the device after (bfloat16 travels as its int16 bits)."""

    def __init__(self, device: torch.device, hidden_size: int, dtype: torch.dtype):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.device = torch.device(device)
        self.hidden_size = hidden_size
        self.dtype = dtype
        self._pin = self.device.type == "cuda"
        #: hops sent and bytes moved by this rank (headers included)
        self.hops = 0
        self.bytes = 0

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        if t.device.type == "cpu":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pin)
        h.copy_(t)
        return h

    def _send(self, t: torch.Tensor, dst: int) -> None:
        h = self._host(t)
        dist.send(h, dst)
        self.hops += 1
        self.bytes += h.numel() * h.element_size()

    def send_hidden(self, h: Optional[torch.Tensor], go: bool = True) -> None:
        """The hidden state ``[B, S, H]`` to the next rank (None with
        ``go=False``: the ring is done)."""
        S = 0 if h is None else h.shape[1]
        self._send(torch.tensor([int(go), S], dtype=torch.int64), self.rank + 1)
        if go:
            self._send(h, self.rank + 1)

    def recv_hidden(self, batch: int = 1) -> Optional[torch.Tensor]:
        """The previous rank's hidden state on this rank's device, or None
        when the ring is done."""
        hdr = torch.empty(2, dtype=torch.int64)
        dist.recv(hdr, self.rank - 1)
        if not int(hdr[0]):
            return None
        wire = torch.int16 if self.dtype == torch.bfloat16 else self.dtype
        buf = torch.empty((batch, int(hdr[1]), self.hidden_size), dtype=wire,
                          pin_memory=self._pin)
        dist.recv(buf, self.rank - 1)
        if self.dtype == torch.bfloat16:
            buf = buf.view(torch.bfloat16)
        return buf.to(self.device, non_blocking=True)

    def send_token(self, tok: torch.Tensor) -> None:
        """The last rank's token ``[B]`` to rank 0."""
        self._send(tok.to(torch.int64), 0)

    def recv_token(self, batch: int = 1) -> torch.Tensor:
        """The token the last rank sent, on this rank's device."""
        buf = torch.empty(batch, dtype=torch.int64)
        dist.recv(buf, self.world - 1)
        return buf.to(self.device)


def ring_generate(cfg: ModelConfig, stage: dict, prompt: np.ndarray, max_new_tokens: int,
                  transport: StageTransport) -> Optional[list]:
    """Greedy generation with the layers split over the ranks, the
    reference's ring (JAX ``cli.py:1125-1160``, ``start_node.py``): rank 0
    embeds, each rank runs its layers over its own KV cache and sends the
    hidden state on, the last rank picks the token and sends it back to
    rank 0, which embeds it for the next step. ``stage`` is this rank's
    ``shard_store.load_stage`` (its layers, the embedding on rank 0, the
    final norm and head on the last rank). Every rank computes its layers
    as ``runtime/generate.generate`` does (the same prefill, the same cache
    views per decode segment), so rank 0's tokens are that function's.
    Rank 0 ends the ring early at a stop id with a header of ``go`` 0,
    which each rank passes on. Returns the generated ids on rank 0, None
    elsewhere."""
    from ..runtime.generate import _cache_view, _segment_capacities

    fns = model_fns(cfg)
    rank, world = transport.rank, transport.world
    dev = transport.device
    prompt = np.asarray(prompt, np.int32).reshape(1, -1)
    S = prompt.shape[1]
    capacity = S + max_new_tokens
    cache = init_cache(cfg, 1, capacity, dtype=transport.dtype, device=dev,
                       num_layers=len(stage["layers"]))
    first, last = rank == 0, rank == world - 1

    def stop_ring() -> None:
        if not last:
            transport.send_hidden(None, go=False)

    def step(ids, pos: np.ndarray, view):
        """One pass of the ring: rank 0 gets the token, the others True,
        or None when rank 0 has ended the ring."""
        positions = to_device(pos.astype(np.int32), dev)
        if first:
            h = fns.embed(cfg, stage, to_device(ids, dev), positions)
        else:
            h = transport.recv_hidden()
            if h is None:
                stop_ring()
                return None
        h, _ = fns.stage(cfg, stage["layers"], h, view, positions)
        if not last:
            transport.send_hidden(h)
        else:
            # the logits of every position, as generate's prefill takes them
            tok = sample(fns.final_logits(cfg, stage, h)[:, -1], 0.0, 0, 1.0)
            if first:
                return tok
            transport.send_token(tok)
        return transport.recv_token() if first else True

    tok = step(prompt, np.arange(S)[None], cache)
    out = [int(tok[0])] if first else None
    done = first and (bool(is_stop(cfg, tok).any()) or max_new_tokens <= 1)
    n, stopped = 1, False
    for cap in _segment_capacities(S + 1, capacity):
        n_limit = min(max_new_tokens, cap - S)
        view = _cache_view(cache, cap)
        while n < n_limit and not done:
            r = step(tok[:, None].cpu().numpy() if first else None, np.array([[S + n - 1]]),
                     view)
            if r is None:
                done = stopped = True
                break
            if first:
                tok = r
                out.append(int(tok[0]))
                done = bool(is_stop(cfg, tok).any())
            n += 1
        cache.length = view.length
        if done or n >= max_new_tokens:
            break
    if first and done and n < max_new_tokens and not stopped:
        stop_ring()  # the other ranks wait for another step
    return out
