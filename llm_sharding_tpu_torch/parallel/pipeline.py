"""Model-family dispatch and the pipeline stage chain (counterpart of
``llm_sharding_tpu/parallel/pipeline.py``: ``ModelFns`` / ``model_fns``
``:68-115``, ``ring_chain`` ``:172``, ``ring_chain_paged`` ``:191``,
``validate_request`` ``:227``, ``check_stage_shapes`` ``:247``,
``ensure_sharded_head`` ``:255``, ``PipelineResult`` ``:272`` and
``pipeline_generate`` ``:444``; ``parallel/mesh.py:53`` ``pipeline_mesh``
becomes ``stage_devices``).

One table per model family, so the serve programs and ``generate`` never
name a family. A model cut into stages is a list of ``Stage``s: each holds
its contiguous layer slice and its vocab shard of the head
(``parallel/head.py``) on its own ``torch.device``, and the hidden state
hops from one stage's device to the next with a ``non_blocking`` copy
(a no-op where stages share a device). The JAX package runs the chain as
one program over a mesh, with ``ppermute`` hops; here the chain is one
process issuing each stage's layers on its device in turn, which is the
same order of work for one request in flight (``pipeline_generate``,
the reference's chain). A one-device params dict is a one-stage chain
(``as_stages``): the serve programs take either.

Tensor parallelism (``parallel/tensor.py``): a stage may run over a
tensor group of ``tp`` devices (``Stage.group``). Its layers are then
``Shards`` of megatron slices, its KV ``HeadShards`` of ``Nkv / tp`` heads
each, and its head stays whole on the group's first device: the vocab is
sharded over the stages only, so the logits are computed once per stage,
not once per shard. ``build_stages`` takes ``stages × tp`` devices in the
JAX grid order, tensor innermost.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import hop, resolve_device
from ..models import gpt2, llama
from ..models.cache import POS_SENTINEL, KVCache, init_cache
from ..models.config import ModelConfig
from ..models.stack import HeadShards
from ..ops.quant import act_dtype, base
from ..ops.sampling import is_stop, sample, validate_top_p
from .head import is_sharded_head, shard_head_host, sp_embed, sp_logits, sp_next_token, stage_head
from .placement import PlacementSpec, split_stage_layers


class ModelFns(NamedTuple):
    """A family's functions, each with one signature across families."""

    embed: Callable  # (cfg, params, ids [B, S], positions [B, S]) -> h
    stage: Callable  # dense layers: (cfg, layers, h, cache, positions, layer_mask=None)
    stage_paged: Callable  # paged layers: forward_layers_paged's signature
    stage_rows: Callable  # dense serve-step layers: forward_layers_rows's signature
    final_logits: Callable  # (cfg, params, h) -> fp32 logits
    forward: Callable  # (cfg, params, ids, cache, positions) -> (logits, cache)


def model_fns(cfg: ModelConfig, tp_axis: Optional[str] = None) -> ModelFns:
    """The family's functions (``pipeline.py:80-116``). ``tp_axis`` is
    taken for the JAX signature: a tensor group is carried by the
    parameters themselves (``Shards`` layers, ``HeadShards`` KV), so the
    same functions serve every tensor degree."""
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


def map_params(fn, tree):
    """``fn`` over every tensor of a parameter tree (dicts, lists, tuples
    and the quantized-weight named tuples), the structure kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_params(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_params(fn, v) for v in tree)
    return tree


class Stage(NamedTuple):
    """One pipeline stage: layers ``[start, end)`` and the head leaves on
    ``device``. ``head`` holds the vocab shard ``[lo, lo + V/S)`` of the
    embedding (and of an untied ``lm_head``) with the final norm and
    GPT-2's ``pos_embed``; a one-stage chain's shard is the whole table."""

    device: torch.device
    start: int
    end: int
    layers: list
    head: dict
    lo: int = 0
    group: tuple = ()  # the tensor group's devices, ``device`` first; () at tp 1

    @property
    def tp(self) -> int:
        """The stage's tensor degree."""
        return max(len(self.group), 1)


def as_stages(model) -> list:
    """The stage list of ``model``: a list of ``Stage``s as it is, or a
    one-device params dict as a one-stage chain over its tensors."""
    if isinstance(model, dict):
        head = {k: v for k, v in model.items() if k != "layers"}
        return [Stage(base(model["embed"]).device, 0, len(model["layers"]), model["layers"], head)]
    return model


def _normal(dev: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current>``, so that equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(devices=None) -> list:
    """``devices`` resolved (a list may repeat a device), or with None
    every visible GPU; without one that raises unless the caller lists the
    CPU (``device.resolve_device``)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [_normal(resolve_device(d)) for d in devices]


def pipe_size(num_virtual: int, n_dev: int) -> int:
    """The executed stage count of a ``num_virtual``-stage chain over
    ``n_dev`` devices (JAX ``runtime/engine.py:152-171``): the chain
    itself where it fits, else the largest device count that divides it
    (each device then runs ``num_virtual / pipe`` consecutive stages,
    ``PlacementSpec.grouped``)."""
    if num_virtual <= n_dev:
        return num_virtual
    for pipe in range(n_dev, 0, -1):
        if num_virtual % pipe == 0:
            return pipe
    raise ValueError(
        f"a {num_virtual}-stage chain needs at least one pipe device; {n_dev} available"
    )


def stage_devices(num_stages: int, devices=None) -> list:
    """One ``torch.device`` per executed stage of a ``num_stages`` chain
    (the counterpart of JAX ``pipeline_mesh``, ``mesh.py:53``)."""
    devs = visible_devices(devices)
    return devs[: pipe_size(num_stages, len(devs))]


def build_stages(cfg: ModelConfig, host_params: dict, spec: PlacementSpec, devices: list,
                 tp: int = 1) -> list:
    """Stage each range of ``spec`` from host (CPU) params onto its device:
    its layers and its vocab shard of the head. Only a stage's own slice
    reaches its device; on the CPU the slices are views of the host
    tensors where no copy is needed. With ``tp`` > 1, ``devices`` holds
    ``tp`` per stage (tensor innermost) and each stage's layers are split
    into their megatron shards over its group (``tensor.shard_layer_tp``),
    its head whole on the group's first device."""
    from .tensor import shard_layer_tp, validate_tp

    if len(devices) != spec.num_stages * tp:
        raise ValueError(
            f"{spec.num_stages} stages need {spec.num_stages} devices, got {len(devices)}"
            if tp == 1 else
            f"{spec.num_stages} stages x tp {tp} need {spec.num_stages * tp} devices, "
            f"got {len(devices)}"
        )
    if tp > 1:
        validate_tp(cfg, tp)
    S = spec.num_stages
    head_host = {k: v for k, v in host_params.items() if k != "layers"}
    sharded = ensure_sharded_head(cfg, head_host, S) if S > 1 else None
    Vs = -(-cfg.vocab_size // S)
    stages = []
    for i, (layers, (a, b)) in enumerate(
        zip(split_stage_layers(spec, host_params["layers"]), spec.stages)
    ):
        group = tuple(devices[i * tp : (i + 1) * tp])
        dev = group[0]
        head = (
            stage_head(sharded, i, dev) if sharded is not None
            else map_params(lambda t, d=dev: t.to(d), head_host)
        )
        if tp > 1:
            staged = [shard_layer_tp(cfg, layer, list(group)) for layer in layers]
        else:
            staged = map_params(lambda t, d=dev: t.to(d), layers)
            group = ()
        stages.append(Stage(dev, a, b, staged, head, i * Vs, group))
    return stages


def chain_embed(cfg: ModelConfig, stages: list, ids: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Token ids → the first layer's input on the first stage's device:
    the family's own embedding on one stage, the vocab-parallel one
    (``head.sp_embed``) on more."""
    if len(stages) == 1:
        return model_fns(cfg).embed(cfg, stages[0].head, ids, positions)
    return sp_embed(cfg, stages, ids, positions)


def run_stages(stages: list, h: torch.Tensor, fn: Callable) -> torch.Tensor:
    """The chain (``ring_chain`` / ``ring_chain_paged``): ``h`` hops onto
    each stage's device and ``fn(i, stage, h)`` runs that stage's layers;
    returns the last stage's output on its device."""
    for i, st in enumerate(stages):
        h = fn(i, st, hop(h, st.device))
    return h


def validate_request(
    cfg: ModelConfig, prompt_tokens: int, max_new_tokens: int, capacity: Optional[int]
) -> int:
    """Request validation of both pipeline schedules; returns the resolved
    capacity (``pipeline.py:227``)."""
    total = prompt_tokens + max_new_tokens
    capacity = capacity or total
    if total > capacity:
        raise ValueError(
            f"prompt ({prompt_tokens}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds cache capacity ({capacity})"
        )
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"requested {total} positions > max_position_embeddings "
            f"({cfg.max_position_embeddings})"
        )
    return capacity


def check_stage_shapes(cfg: ModelConfig, stages: list) -> None:
    """The chain covers the model's layers contiguously, each stage holding
    exactly its range (``pipeline.py:247``)."""
    prev = 0
    for i, st in enumerate(stages):
        if st.start != prev or len(st.layers) != st.end - st.start:
            raise ValueError(
                f"stage {i} holds {len(st.layers)} layers for range [{st.start}, {st.end}) "
                f"after layer {prev}: stage params do not form the chain"
            )
        prev = st.end
    if prev != cfg.num_hidden_layers:
        raise ValueError(
            f"chain covers layers [0, {prev}) but the model has {cfg.num_hidden_layers} layers"
        )


def ensure_sharded_head(cfg: ModelConfig, head_params: dict, num_stages: int) -> dict:
    """A full head dict, or one already stacked by ``shard_head_host``, as
    the stacked form for ``num_stages`` (``pipeline.py:255``)."""
    if is_sharded_head(head_params):
        got = base(head_params["embed"]).shape[0]
        if got != num_stages:
            raise ValueError(
                f"head was vocab-sharded for {got} stages but the mesh has "
                f"{num_stages}; re-shard with shard_head_host"
            )
        return head_params
    return shard_head_host(cfg, head_params, num_stages)


class PipelineResult(NamedTuple):
    tokens: np.ndarray  # [B, S + max_new_tokens]
    lengths: np.ndarray  # [B]


def chain_caches(cfg: ModelConfig, stages: list, batch: int, capacity: int, dtype) -> list:
    """One dense KV cache per stage, ``[L_stage, B, C, Nkv, D]`` on its
    device; a tensor-parallel stage's ``k`` / ``v`` are ``HeadShards`` of
    ``Nkv / tp`` heads per shard, its ``pos`` on the group's first device."""
    caches = []
    for st in stages:
        L = st.end - st.start
        if st.tp == 1:
            caches.append(init_cache(cfg, batch, capacity, dtype=dtype, device=st.device,
                                     num_layers=L))
            continue
        shape = (L, batch, capacity, cfg.num_key_value_heads // st.tp, cfg.head_dim_)
        k, v = (HeadShards([torch.zeros(shape, dtype=dtype, device=d) for d in st.group])
                for _ in range(2))
        pos = torch.full((batch, capacity), POS_SENTINEL, dtype=torch.int32, device=st.device)
        caches.append(KVCache(k=k, v=v, pos=pos))
    return caches


def chain_forward(cfg: ModelConfig, stages: list, h: torch.Tensor, caches: list,
                  positions: torch.Tensor) -> torch.Tensor:
    """The dense layers of every stage over their caches (written in
    place); returns the last stage's hidden state on its device."""
    fns = model_fns(cfg)

    def stage(i, st, h):
        return fns.stage(cfg, st.layers, h, caches[i], hop(positions, st.device))[0]

    return run_stages(stages, h, stage)


def mesh_axis_sizes(grid) -> tuple:
    """(data, pipe, tensor) sizes of a device grid (``parallel/mesh.Grid``;
    absent axes count as 1), ``pipeline.py:118``."""
    from .mesh import DATA_AXIS, PIPE_AXIS
    from .tensor import TENSOR_AXIS

    shape = dict(grid.shape)
    return shape.get(DATA_AXIS, 1), shape.get(PIPE_AXIS, 1), shape.get(TENSOR_AXIS, 1)


def stage_layer_specs(cfg: ModelConfig, tp: int, stage_layers: Optional[dict] = None):
    """The split rule of each layer leaf of a stage over a tensor group of
    ``tp`` (``pipeline.py:132-165``): None at tp 1 (no split), else the
    family's rules (``tensor.tp_specs``), per component for a quantized
    leaf of ``stage_layers`` (one layer's dict; its keys select the rules),
    the whole table without it."""
    if tp == 1:
        return None
    from .tensor import quant_leaf_spec, tp_specs

    per_leaf = tp_specs(cfg)["layers"]
    if stage_layers is None:
        return dict(per_leaf)
    return {k: quant_leaf_spec(per_leaf[k], v) for k, v in stage_layers.items()}


def _replica_seed(seed: int, d: int) -> int:
    """The sampling seed of data-parallel replica ``d``: ``seed`` itself for
    the first, a distinct one for each other (JAX folds the replica index
    into its key, ``pipeline.py:318-324``: deterministic, and not the
    monolith's stream past the first replica)."""
    return int(seed) if d == 0 else (int(seed) * 1_000_003 + d) % (2**63)


def pipeline_generate(
    cfg: ModelConfig,
    stages: list,
    prompt_ids,
    max_new_tokens: int = 128,
    *,
    prompt_len=None,
    capacity: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    prompt_embeds=None,  # [B, S, H]: the privacy entry, ids never enter
) -> PipelineResult:
    """Generation through the stage chain, one request batch in flight,
    the reference's sequential chain (``pipeline.py:444``): prefill the
    right-padded prompts through every stage, then one trip down the
    chain per token. Greedy ids come from the vocab-sharded head; a
    sampled step gathers the logits onto the first stage's device and
    draws from one ``torch.Generator`` seeded with ``seed`` there, so the
    tokens equal ``runtime/generate.generate``'s on one stage. With
    ``prompt_embeds`` the prompt enters as hidden states and
    ``prompt_ids`` only sizes the output (pass zeros).

    ``stages`` may be a list of chains, one per data-parallel replica
    (``Engine(data_parallel=)``): replica ``d`` takes rows ``[d, d + 1) *
    B / dp`` and the batch must divide; the replicas run one after the
    other in this process, each until its own rows stop. Stages over a
    tensor group (``Stage.group``) run their megatron shards."""
    if stages and isinstance(stages[0], list):
        dp = len(stages)
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        B = prompt.shape[0]
        if B % dp != 0:
            raise ValueError(f"batch {B} not divisible by data-parallel size {dp}")
        Bl = B // dp
        plen = None if prompt_len is None else np.asarray(prompt_len, np.int64)
        parts = [
            pipeline_generate(
                cfg, chain, prompt[d * Bl : (d + 1) * Bl], max_new_tokens,
                prompt_len=None if plen is None else plen[d * Bl : (d + 1) * Bl],
                capacity=capacity, temperature=temperature, top_k=top_k, top_p=top_p,
                seed=_replica_seed(seed, d),
                prompt_embeds=None if prompt_embeds is None
                else np.asarray(prompt_embeds)[d * Bl : (d + 1) * Bl],
            )
            for d, chain in enumerate(stages)
        ]
        return PipelineResult(np.concatenate([r.tokens for r in parts]),
                              np.concatenate([r.lengths for r in parts]))
    prompt = np.asarray(prompt_ids, np.int32)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, S = prompt.shape
    plen = np.full(B, S, np.int64) if prompt_len is None else np.asarray(prompt_len, np.int64)
    capacity = validate_request(cfg, S, max_new_tokens, capacity)
    check_stage_shapes(cfg, stages)
    top_p = validate_top_p(top_p)
    temperature = float(temperature)
    gen = (torch.Generator(device=stages[0].device).manual_seed(int(seed))
           if temperature > 0 else None)

    def pick(h):  # [B, H] -> [B] int32 on the first device
        if gen is None:
            return sp_next_token(cfg, stages, h)
        return sample(sp_logits(cfg, stages, h), temperature, int(top_k), top_p, generator=gen)

    return chain_generate(cfg, stages, prompt, plen, max_new_tokens, capacity, pick, prompt_embeds)


def chain_generate(cfg: ModelConfig, stages: list, prompt: np.ndarray, plen: np.ndarray,
                   max_new_tokens: int, capacity: int, pick: Callable,
                   prompt_embeds=None) -> PipelineResult:
    """The generation loop of both schedules: prefill ``prompt [B, S]``
    (real lengths ``plen``) through the chain, then one trip per token
    until every row stopped or the budget; ``pick(h [B, H])`` chooses the
    next ids on the first stage's device."""
    dev = stages[0].device
    B, S = prompt.shape
    dtype = act_dtype(stages[0].head["embed"])
    caches = chain_caches(cfg, stages, B, capacity, dtype)
    idx = np.arange(S)[None, :]
    positions = torch.from_numpy(
        np.where(idx < plen[:, None], idx, POS_SENTINEL).astype(np.int32)
    ).to(dev)
    if prompt_embeds is None:
        h = chain_embed(cfg, stages, torch.from_numpy(prompt).to(dev), positions)
    else:
        h = torch.as_tensor(np.asarray(prompt_embeds, np.float32)).to(dev, dtype)
        if tuple(h.shape) != (B, S, cfg.hidden_size):
            raise ValueError(f"prompt_embeds {tuple(h.shape)} does not match [{B}, {S}, "
                             f"{cfg.hidden_size}]")
    h = chain_forward(cfg, stages, h, caches, positions)
    rows = torch.arange(B, device=h.device)
    tok = pick(h[rows, torch.from_numpy(plen - 1).to(h.device)])

    out = np.zeros((B, S + max_new_tokens), np.int32)
    out[:, :S] = prompt
    out[np.arange(B), plen] = tok.cpu().numpy()
    done = is_stop(cfg, tok).cpu().numpy()
    lengths = plen + 1
    pos = plen.copy()
    for _ in range(1, max_new_tokens):
        if done.all():
            break
        step_pos = torch.from_numpy(pos[:, None].astype(np.int32)).to(dev)
        h = chain_forward(cfg, stages, chain_embed(cfg, stages, tok[:, None], step_pos),
                          caches, step_pos)
        nxt = pick(h[:, 0])
        nxt = torch.where(torch.from_numpy(done).to(dev), torch.zeros_like(nxt), nxt)
        pos = pos + 1
        out[np.arange(B), pos] = nxt.cpu().numpy()
        lengths = np.where(done, lengths, lengths + 1)
        done = done | is_stop(cfg, nxt).cpu().numpy()
        tok = nxt
    return PipelineResult(out, lengths.astype(np.int32))
