"""Model configuration: the port's own copy of
``llm_sharding_tpu/models/config.py:18-205`` (``RopeScaling``,
``ModelConfig`` and its JSON form) with the presets this slice uses. The
HuggingFace mapping (``from_hf_config``) comes with the convert slice.

The dataclass is stdlib-only, but the port cannot import the JAX
package's copy: ``llm_sharding_tpu/models/__init__.py`` imports jax. The
JSON form is the shard store's ``config.json``, so either package reads
the other's stores.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style RoPE frequency scaling (``rope_type="llama3"``)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for a causal LM.

    ``model_type`` selects the block structure ("llama" or "gpt2"); this
    slice of the port runs the llama family (llama / qwen2 / gemma-1).
    """

    model_type: str = "llama"  # "llama" | "gpt2"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    # llama-family block variants (Gemma: gelu MLP, sqrt(H)-scaled
    # embeddings, RMSNorm computing out*(offset+w) in fp32)
    hidden_act: str = "silu"  # "silu" | "gelu_tanh"
    norm_offset: float = 0.0
    embed_multiplier: float = 1.0
    # GPT-2 specifics
    layer_norm_epsilon: float = 1e-5
    # Token ids. ``eos_token_ids`` holds ALL stop ids (Llama-3.x instruct
    # models ship several, e.g. <|end_of_text|> and <|eot_id|>); decode loops
    # must stop on any of them. ``eos_token_id`` is the primary/first one.
    bos_token_id: int = 1
    eos_token_id: int = 2
    eos_token_ids: tuple = ()

    def __post_init__(self):
        if not self.eos_token_ids:
            object.__setattr__(self, "eos_token_ids", (self.eos_token_id,))
        else:
            object.__setattr__(self, "eos_token_ids", tuple(self.eos_token_ids))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ModelConfig":
        d = json.loads(text)
        if d.get("rope_scaling") is not None:
            d["rope_scaling"] = RopeScaling(**d["rope_scaling"])
        return cls(**d)


# Presets: the model this slice serves on the card, and the tiny CPU-test
# configurations (``llm_sharding_tpu/models/config.py:249-264, 343-371``).
def llama32_3b() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256,
        hidden_size=3072,
        intermediate_size=8192,
        num_hidden_layers=28,
        num_attention_heads=24,
        num_key_value_heads=8,
        head_dim=128,
        max_position_embeddings=8192,
        rope_theta=500000.0,
        rope_scaling=RopeScaling(factor=32.0),
        tie_word_embeddings=True,
        bos_token_id=128000,
        eos_token_id=128001,
    )


def tiny_qwen2(**kw) -> ModelConfig:
    """Tiny qwen2-layout config (llama + qkv biases) for CPU tests: what the
    JAX preset's HF mapping of ``model_type="qwen2"`` yields."""
    return tiny_llama(**{"attention_bias": True, **kw})


def tiny_llama(**kw) -> ModelConfig:
    """Tiny llama config for CPU tests."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=4,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=128,
    )
    base.update(kw)
    return ModelConfig(**base)
