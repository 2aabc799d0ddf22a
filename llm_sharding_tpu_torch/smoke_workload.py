"""The served workload of ``chip_smoke.py`` phase (d), also replayed by
``serve_profile``: 8 staggered requests on Llama-3.2-3B, 4 prompts of
20-200 tokens (one-shot flash admission at ``prefill_chunk=256``) and 4 of
1024-2048 tokens (chunked admission), 64 new tokens each. A change here
changes what both measure.
"""

from __future__ import annotations

import numpy as np

LENS = (20, 1024, 90, 1536, 150, 2048, 200, 1800)
MAX_NEW = 64


def prompts(vocab_size: int, rng: np.random.Generator) -> list:
    return [rng.integers(0, vocab_size, n).astype(np.int32) for n in LENS]


def submit_staggered(srv, prompts) -> list:
    """Two new requests, then two server steps, until all are submitted;
    the caller runs the server to idle."""
    reqs = []
    for i in range(0, len(prompts), 2):
        reqs += [srv.submit(p, MAX_NEW) for p in prompts[i : i + 2]]
        srv.step()
        srv.step()
    return reqs
