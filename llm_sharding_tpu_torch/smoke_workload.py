"""The served workloads of ``chip_smoke.py`` phase (d), also replayed by
``serve_profile``: 8 staggered requests, 64 new tokens each, 8 rows, block
size 64, ``prefill_chunk=256``, 4 short prompts (one-shot flash admission)
and 4 long ones (chunked admission). A change here changes what both
measure.

- Llama-3.2-3B: prompts of 20-200 and 1024-2048 tokens, capacity 4096,
  1024 blocks.
- gemma-2B and gemma-7B: the 3B's workload (gemma-2B's arena of 1024
  blocks holds 1.21 GB in bf16: one KV head of 256 over 18 layers).
- GPT-2 small: prompts of 20-200 and 320-512 tokens, capacity 1024 (its
  position limit), 256 blocks. A prompt over 512 tokens falls in the
  1024-token admission bucket, which with any new token exceeds the 1024
  positions, so 512 is the longest prompt GPT-2 can be served here; each
  long prompt is admitted in two chunks, at frontiers 256 and 512.

The shared-prefix workload (``SHARED_PREFIX``, a workload of its own: the
ones above stay as they are) is the traffic the prefix cache exists for,
a system prompt shared by every request, as in chat serving: one seeded
1024-token prefix (16 blocks), a primer request (the prefix and 64 more
tokens, run to idle so the prefix's 16 blocks are in the tree), then 8
staggered requests, each the prefix and a suffix of 20-1000 tokens. With
the cache on, the short suffixes admit one-shot (flash with S = the suffix
bucket over C = 1024 + S keys) and the long ones chunked from column 1024;
with it off, every request prefills its whole prompt.

The resilience workload (``RESILIENCE``, another entry of its own) is the
3B's standard 8 prompts over an arena of 320 blocks instead of 1024: a
daemon that must outlive a sticky CUDA fault (restored from a snapshot in
a new process) or a drained replica (its live rows migrated) checkpoints
and moves the arena it holds, so the arena is sized to what the workload
maps at once (135 blocks: 2.19 GiB in bf16, about 1.09 GiB in int8 or fp8)
rather than to the card. No admission waits for blocks.

Llama-2-7B (``llama2_7b``) serves the 3B's 8 prompts over 320 blocks
(10.7 GB in bf16: 32 KV heads of 128 over 32 layers take 33.5 MB a block),
the blocks the workload maps at once (135) with room to spare.

The speculative workload (``SPECULATIVE``, another entry of its own) is
the traffic prompt-lookup drafting exists for: code edits and document
QA, where the answer quotes the prompt. Each of the 3B's 8 standard prompt
lengths is one seeded 64-token passage repeated up to that length. The
server runs ``speculate=4``, ``spec_ngram=3`` and no ``prefill_chunk``
(speculation refuses chunked admission), so every admission is one-shot
through flash, up to S = 2048, and every decode step is a verify through
the decode kernel at S = 5.

The fleet (``FLEET``, ``fleet_order``, ``fleet_kwargs``,
``fleet_daemon_args``) serves the standard 8 prompts over the resilience
workload's arena, 320 blocks in each replica, through two replicas on the
one card (``runtime/replicated.py``; a failover, a drain and a spawn
mid-decode), one prefill and one decode replica (``runtime/disagg.py``,
``prefix_cache="hbm"``), and the ``serve --data-parallel 2 --disagg``
daemon, each beside the one-replica twin. The prompts go in with every
second pair swapped: the router's round robin then gives each replica
two short (one-shot) and two long (chunked) prompts, so each launches
every kernel, where the standard order would put every short prompt on
one replica and every long one on the other.

The front door (``serve(dense=True)`` and ``daemon_args``) serves the
standard workload as users send it: through the ``serve`` command's HTTP
ingress, as token-id prompts from the two tenants of ``TENANTS``
(alternating; half the requests streamed, ``streamed``), dense (the command's
default: per-row caches of the capacity, no blocks) or paged (the
standard arena). The in-process twin of each daemon is ``serve`` with the
same layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_NEW = 64
ROWS = 8
BLOCK_SIZE = 64
PREFILL_CHUNK = 256


class Workload(NamedTuple):
    lens: tuple  # prompt lengths, in submit order
    capacity: int
    kv_blocks: int


WORKLOADS = {
    "llama32_3b": Workload((20, 1024, 90, 1536, 150, 2048, 200, 1800), 4096, 1024),
    "gpt2_small": Workload((20, 512, 90, 384, 150, 448, 200, 320), 1024, 256),
}
WORKLOADS["gemma_2b"] = WORKLOADS["gemma_7b"] = WORKLOADS["llama32_3b"]
WORKLOADS["llama2_7b"] = Workload(WORKLOADS["llama32_3b"].lens, 4096, 320)
LENS = WORKLOADS["llama32_3b"].lens


class SharedPrefix(NamedTuple):
    prefix: int  # tokens of the shared prefix
    primer_tail: int  # tokens the primer adds past the prefix
    suffixes: tuple  # suffix lengths, in submit order
    capacity: int
    kv_blocks: int


SHARED_PREFIX = {
    "llama32_3b": SharedPrefix(1024, 64, (20, 400, 90, 600, 150, 800, 200, 1000), 4096, 1024),
}
SHARED_PREFIX["gemma_2b"] = SHARED_PREFIX["llama32_3b"]

RESILIENCE = {"llama32_3b": Workload(WORKLOADS["llama32_3b"].lens, 4096, 320)}


class Speculative(NamedTuple):
    lens: tuple  # prompt lengths, in submit order
    passage: int  # tokens of the seeded passage each prompt repeats
    capacity: int
    kv_blocks: int
    speculate: int  # K: drafts verified per row per step
    spec_ngram: int  # the longest suffix the drafter matches


SPECULATIVE = {
    "llama32_3b": Speculative(LENS, 64, 4096, 1024, 4, 3),
    "llama2_7b": Speculative(LENS, 64, 4096, 320, 4, 3),
}


FLEET = {"llama32_3b": RESILIENCE["llama32_3b"]}


def fleet_order(prompts: list) -> list:
    """The standard prompts with every second pair swapped (long first)."""
    out = list(prompts)
    for i in range(2, len(out) - 1, 4):
        out[i], out[i + 1] = out[i + 1], out[i]
    return out


def fleet_kwargs(model: str) -> dict:
    """The serve options of each replica of ``model``'s fleet cell."""
    w = FLEET[model]
    return dict(capacity=w.capacity, batch_per_slot=ROWS, kv_block_size=BLOCK_SIZE,
                kv_blocks=w.kv_blocks, prefill_chunk=PREFILL_CHUNK)


def fleet_daemon_args(model: str) -> list:
    """``serve``'s flags for the fleet cell's disaggregated daemon: two
    replicas, one prefill and one decode, hand-offs through the tree."""
    w = FLEET[model]
    return ["--capacity", str(w.capacity), "--batch-per-slot", str(ROWS),
            "--prefill-chunk", str(PREFILL_CHUNK), "--max-new", str(MAX_NEW),
            "--kv-block-size", str(BLOCK_SIZE), "--kv-blocks", str(w.kv_blocks),
            "--data-parallel", "2", "--disagg", "--prefix-cache", "hbm"]


def prompts(vocab_size: int, rng: np.random.Generator, lens=LENS) -> list:
    return [rng.integers(0, vocab_size, n).astype(np.int32) for n in lens]


#: the front door's tenants: two keyed tenants of equal weight
TENANTS = {"tenants": {"alice": {"key": "sk-alice"}, "bob": {"key": "sk-bob"}},
           "allow_anonymous": False}


def streamed(i: int) -> bool:
    """Whether the front door's ``i``-th request streams: the first of each
    two pairs, so each tenant streams one short and one long prompt."""
    return (i // 2) % 2 == 0


def daemon_args(model: str, dense: bool) -> list:
    """The ``serve`` command's flags for ``model``'s standard workload, dense
    (``--capacity`` alone) or over its paged arena: what ``serve(eng,
    model, dense=dense)`` builds in-process."""
    w = WORKLOADS[model]
    args = ["--capacity", str(w.capacity), "--batch-per-slot", str(ROWS),
            "--prefill-chunk", str(PREFILL_CHUNK), "--max-new", str(MAX_NEW)]
    if not dense:
        args += ["--kv-block-size", str(BLOCK_SIZE), "--kv-blocks", str(w.kv_blocks)]
    return args


def serve(eng, model: str, shared_prefix: bool = False, resilience: bool = False,
          speculative: bool = False, dense: bool = False, **kw):
    """A server for ``model``'s workload on ``eng`` (``kw``: e.g. kv_dtype,
    prefix_cache); ``shared_prefix`` picks its ``SHARED_PREFIX`` entry,
    ``resilience`` its ``RESILIENCE`` one, ``speculative`` its
    ``SPECULATIVE`` one (``kw`` may set ``speculate=0``: the same one-shot
    server without speculation); ``dense`` the standard workload on dense
    per-row caches."""
    if dense:
        w = WORKLOADS[model]
        return eng.serve(capacity=w.capacity, batch_per_slot=ROWS, prefill_chunk=PREFILL_CHUNK,
                         **kw)
    if speculative:
        w = SPECULATIVE[model]
        kw = dict(dict(speculate=w.speculate, spec_ngram=w.spec_ngram), **kw)
        return eng.serve(capacity=w.capacity, batch_per_slot=ROWS, kv_block_size=BLOCK_SIZE,
                         kv_blocks=w.kv_blocks, **kw)
    w = (RESILIENCE if resilience else SHARED_PREFIX if shared_prefix else WORKLOADS)[model]
    return eng.serve(capacity=w.capacity, batch_per_slot=ROWS, kv_block_size=BLOCK_SIZE,
                     kv_blocks=w.kv_blocks, prefill_chunk=PREFILL_CHUNK, **kw)


def shared_prefix_prompts(vocab_size: int, rng: np.random.Generator, w: SharedPrefix) -> tuple:
    """``(primer, prompts)`` of a shared-prefix workload: the prefix and
    ``primer_tail`` tokens, then the prefix and each suffix."""
    prefix = rng.integers(0, vocab_size, w.prefix).astype(np.int32)

    def tail(n):
        return np.concatenate([prefix, rng.integers(0, vocab_size, n).astype(np.int32)])

    return tail(w.primer_tail), [tail(n) for n in w.suffixes]


def speculative_prompts(vocab_size: int, rng: np.random.Generator, w: Speculative) -> list:
    """One seeded ``w.passage``-token passage, repeated up to each length."""
    passage = rng.integers(0, vocab_size, w.passage).astype(np.int32)
    return [np.resize(passage, n) for n in w.lens]


def submit_staggered(srv, prompts) -> list:
    """Two new requests, then two server steps, until all are submitted;
    the caller runs the server to idle."""
    reqs = []
    for i in range(0, len(prompts), 2):
        reqs += [srv.submit(p, MAX_NEW) for p in prompts[i : i + 2]]
        srv.step()
        srv.step()
    return reqs
