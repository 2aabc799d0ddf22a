"""Model-family dispatch (counterpart of ``ModelFns`` / ``model_fns`` in
``llm_sharding_tpu/parallel/pipeline.py:68-115``, with the family
branches of ``parallel/head.py:145-190``: GPT-2 adds ``pos_embed`` at
embed time and ends in a LayerNorm).

One table per family, so the serve programs and ``generate`` never name a
family. Pipeline stages themselves come with a later slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..models import gpt2, llama
from ..models.config import ModelConfig


class ModelFns(NamedTuple):
    """A family's functions, each with one signature across families."""

    embed: Callable  # (cfg, params, ids [B, S], positions [B, S]) -> h
    stage: Callable  # dense layers: (cfg, layers, h, cache, positions, layer_mask=None)
    stage_paged: Callable  # paged layers: forward_layers_paged's signature
    stage_rows: Callable  # dense serve-step layers: forward_layers_rows's signature
    final_logits: Callable  # (cfg, params, h) -> fp32 logits
    forward: Callable  # (cfg, params, ids, cache, positions) -> (logits, cache)


def model_fns(cfg: ModelConfig) -> ModelFns:
    if cfg.model_type == "llama":
        m = llama
    elif cfg.model_type == "gpt2":
        m = gpt2
    else:
        raise ValueError(f"unsupported model_type: {cfg.model_type!r}")
    return ModelFns(
        m.embed, m.forward_layers, m.forward_layers_paged, m.forward_layers_rows,
        m.final_logits, m.forward,
    )
