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
LENS = WORKLOADS["llama32_3b"].lens


def prompts(vocab_size: int, rng: np.random.Generator, lens=LENS) -> list:
    return [rng.integers(0, vocab_size, n).astype(np.int32) for n in lens]


def serve(eng, model: str, **kw):
    """A server for ``model``'s workload on ``eng`` (``kw``: e.g. kv_dtype)."""
    w = WORKLOADS[model]
    return eng.serve(capacity=w.capacity, batch_per_slot=ROWS, kv_block_size=BLOCK_SIZE,
                     kv_blocks=w.kv_blocks, prefill_chunk=PREFILL_CHUNK, **kw)


def submit_staggered(srv, prompts) -> list:
    """Two new requests, then two server steps, until all are submitted;
    the caller runs the server to idle."""
    reqs = []
    for i in range(0, len(prompts), 2):
        reqs += [srv.submit(p, MAX_NEW) for p in prompts[i : i + 2]]
        srv.step()
        srv.step()
    return reqs
