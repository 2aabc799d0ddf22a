"""Serve programs over the paged KV arena, one stage on one device: the port
of ``llm_sharding_tpu/parallel/serve.py`` (``ServeState`` ``:71-111``,
``serve_admit`` ``:542``, ``serve_prefill_chunk`` ``:861``,
``serve_admit_finish`` ``:1074``, ``serve_chunk`` ``:1198``).

There is no mesh: with one stage the JAX package's ring degenerates to a
plain pass over the layers, so the in-flight ring block, its validity bit
and the per-slot schedule fields have no counterpart here. Rows are
independent: each admission fills whichever rows are free, and one decode
step advances every live row by one token. Pipeline stages come with a
later slice. The model family's functions come from one table
(``parallel/pipeline.model_fns``), so every program serves llama-family
and GPT-2 weights alike, raw or quantized.

The arena and the per-column key positions live on the device; the small
per-row bookkeeping (positions, write offsets, lengths, budgets, the token
buffer) lives on the host, because the host reads every committed token
anyway to stream it.

A quantized arena (``kv_dtype`` int8 / fp8) holds 1-byte codes with
per-(block, KV head) f32 scales, as in the JAX state. The dense prefill of
a one-shot admission still runs in the engine's dtype; its window is
quantized as it is scattered (``scatter_pages_q``). A chunked admission
resets its rows' block scales on the first chunk, and every later write
(chunks, decode) quantizes against the running block absmax
(``ops/paged_attention.write_block_kv``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.cache import POS_SENTINEL, block_pool_shape, block_scale_shape, init_cache
from ..models.config import ModelConfig
from ..ops.paged_attention import write_block_kv
from ..ops.quant import is_kv_quantized, kv_qmax, kv_quantize, kv_storage_dtype
from ..ops.sampling import sample
from .pipeline import model_fns


@dataclasses.dataclass
class ServeState:
    """The fields of the JAX ``ServeState`` that one stage needs."""

    k: torch.Tensor  # [L, NB, BS, Nkv, D] pooled arena; block 0 = trash
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # [L, NB, Nkv] f32 of an int8/fp8 arena, else None
    v_scale: Optional[torch.Tensor]
    cache_dtype: torch.dtype  # the engine's dtype: dense prefill cache, attention queries
    kpos: torch.Tensor  # [M, W] int32 key position per LOGICAL column
    block_tables: torch.Tensor  # [M, T] int32 (the server owns the host mirror)
    pos_slots: np.ndarray  # [M] position of each row's next input token
    write_off: np.ndarray  # [M] logical column that token's KV lands in
    out: np.ndarray  # [M, W] int32 prompt + generated tokens
    lengths: np.ndarray  # [M] valid length (prompt + generated)
    done: np.ndarray  # [M] bool; free and parked rows are done
    budget: np.ndarray  # [M] max total length (prompt + max_new)
    tok: np.ndarray  # [M] next input token of each row
    temp: np.ndarray  # [M] f32 sampling temperature (<= 0 greedy)
    topk: np.ndarray  # [M] int32 (0 off)
    topp: np.ndarray  # [M] f32 (1.0 off)
    rng: list  # [M] per-row torch.Generator of a sampled row, else None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]


def make_state(
    cfg: ModelConfig,
    rows: int,
    *,
    capacity: int,
    kv_blocks: int,
    kv_block_size: int,
    dtype: torch.dtype,
    device: torch.device,
    kv_dtype: str = "bf16",
) -> ServeState:
    """Empty state: every row free (done), every table entry trash. Each
    row's logical window is ``W = ceil(capacity / BS) * BS`` columns.
    ``kv_dtype`` "int8"/"fp8" allocates 1-byte arenas and zero scales;
    "bf16" stores in ``dtype``, the engine's own."""
    T = -(-capacity // kv_block_size)
    W = T * kv_block_size
    shape = block_pool_shape(cfg, kv_blocks, kv_block_size)
    store = kv_storage_dtype(kv_dtype, dtype)
    quantized = is_kv_quantized(store)

    def arena():
        if quantized:  # zero bytes, viewed: fills of fp8 tensors are not everywhere
            return torch.zeros(shape, dtype=torch.uint8, device=device).view(store)
        return torch.zeros(shape, dtype=store, device=device)

    def scales():
        if not quantized:
            return None
        return torch.zeros(block_scale_shape(cfg, kv_blocks), dtype=torch.float32, device=device)

    return ServeState(
        k=arena(),
        v=arena(),
        k_scale=scales(),
        v_scale=scales(),
        cache_dtype=dtype,
        kpos=torch.full((rows, W), POS_SENTINEL, dtype=torch.int32, device=device),
        block_tables=torch.zeros((rows, T), dtype=torch.int32, device=device),
        pos_slots=np.zeros(rows, np.int64),
        write_off=np.zeros(rows, np.int64),
        out=np.zeros((rows, W), np.int32),
        lengths=np.zeros(rows, np.int64),
        done=np.ones(rows, bool),
        budget=np.zeros(rows, np.int64),
        tok=np.zeros(rows, np.int32),
        temp=np.zeros(rows, np.float32),
        topk=np.zeros(rows, np.int32),
        topp=np.ones(rows, np.float32),
        rng=[None] * rows,
    )


def _arm_sampling(state: ServeState, rows, seeds, temps, topks, topps) -> None:
    """Per-row sampling settings; a sampled row gets its own generator
    seeded with the request's seed, so its draws equal ``generate``'s at
    batch 1."""
    dev = state.k.device
    for i, r in enumerate(rows):
        state.temp[r] = max(float(temps[i]), 0.0)
        state.topk[r] = int(topks[i])
        state.topp[r] = float(topps[i])
        state.rng[r] = (
            torch.Generator(device=dev).manual_seed(int(seeds[i]))
            if state.temp[r] > 0 else None
        )


def _sample_rows(state: ServeState, rows, logits: torch.Tensor) -> np.ndarray:
    """One token per row: greedy rows by one argmax, sampled rows each
    from its own generator."""
    toks = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    for i, r in enumerate(rows):
        if state.temp[r] > 0:
            toks[i] = int(sample(
                logits[i : i + 1], float(state.temp[r]), int(state.topk[r]),
                float(state.topp[r]), generator=state.rng[r],
            )[0])
    return toks


def _stop_mask(cfg: ModelConfig, toks: np.ndarray) -> np.ndarray:
    """``ops/sampling.is_stop`` on host token ids."""
    return np.isin(toks, cfg.eos_token_ids)


def scatter_pages_q(
    arena: torch.Tensor,  # [NB, BS, Nkv, D] 1-byte codes, written in place
    scale: torch.Tensor,  # [NB, Nkv] f32, written in place
    block_table: torch.Tensor,  # [n, T] the rows' tables
    window: torch.Tensor,  # [n, Sp, Nkv, D] the rows' fresh KV in columns [0, Sp)
) -> None:
    """Quantizing scatter of one layer of a one-shot admission
    (``_scatter_pages_q``, ``serve.py:194-212``): each row's WHOLE logical
    window, ``window`` followed by zeros, lands through its table as codes,
    and every mapped block's scale is RESET to its new content's absmax /
    qmax. Not the running max: a recycled block would keep its previous
    occupant's larger scale and store coarser codes. The trash entries of
    a table receive garbage, as in the JAX program."""
    n, T = block_table.shape
    BS, Nkv, D = arena.shape[1:]
    full = torch.zeros((n, T * BS, Nkv, D), dtype=window.dtype, device=window.device)
    full[:, : window.shape[1]] = window
    vals = full.reshape(n, T, BS, Nkv, D)
    sc = vals.float().abs().amax(dim=(2, 4)) / kv_qmax(arena.dtype)  # [n, T, Nkv]
    codes = kv_quantize(vals, sc[:, :, None, :, None], arena.dtype)
    idx = block_table.long()
    arena.view(torch.uint8)[idx] = codes.view(torch.uint8)
    scale[idx] = sc


def serve_admit(
    cfg: ModelConfig,
    params: dict,
    state: ServeState,
    rows: list,
    prompts: np.ndarray,  # [n, Sp] right-padded (Sp = the admission bucket)
    prompt_len: np.ndarray,  # [n]
    max_new: np.ndarray,  # [n]
    seeds: np.ndarray,
    temps: np.ndarray,
    topks: np.ndarray,
    topps: np.ndarray,
) -> np.ndarray:
    """One-shot admission: prefill the rows' prompts through the dense
    layer path (the flash kernel), scatter the fresh window into the rows'
    blocks (their tables are on the device already) and sample each row's
    first token, which is returned. The first decode step then feeds that
    token at position ``prompt_len`` into column ``Sp``."""
    dev = state.k.device
    n, Sp = prompts.shape
    rows_t = torch.as_tensor(rows, device=dev)
    idx = np.arange(Sp)[None, :]
    positions = np.where(idx < prompt_len[:, None], idx, POS_SENTINEL).astype(np.int32)
    pos_t = torch.from_numpy(positions).to(dev)
    cache = init_cache(cfg, n, Sp, dtype=state.cache_dtype, device=dev)
    fns = model_fns(cfg)
    h = fns.embed(cfg, params, torch.from_numpy(prompts).to(dev), pos_t)
    h, cache = fns.stage(cfg, params["layers"], h, cache, pos_t)
    last = torch.from_numpy(prompt_len - 1).to(dev)
    h_last = h[torch.arange(n, device=dev), last][:, None]
    logits = fns.final_logits(cfg, params, h_last)[:, 0]
    _arm_sampling(state, rows, seeds, temps, topks, topps)
    tok0 = _sample_rows(state, rows, logits)

    tbl = state.block_tables[rows_t]
    cols = torch.arange(Sp, device=dev).expand(n, Sp)
    for layer in range(cache.num_layers):
        if state.k_scale is None:
            write_block_kv(
                state.k[layer], state.v[layer], tbl, cols, cache.k[layer], cache.v[layer]
            )
            continue
        scatter_pages_q(state.k[layer], state.k_scale[layer], tbl, cache.k[layer])
        scatter_pages_q(state.v[layer], state.v_scale[layer], tbl, cache.v[layer])
    kpos = torch.full((n, state.kpos.shape[1]), POS_SENTINEL, dtype=torch.int32, device=dev)
    kpos[:, :Sp] = pos_t
    state.kpos[rows_t] = kpos

    stop = _stop_mask(cfg, tok0)
    for i, r in enumerate(rows):
        plen = int(prompt_len[i])
        state.out[r] = 0
        state.out[r, :Sp] = prompts[i]
        state.out[r, plen] = tok0[i]
        state.write_off[r] = Sp
        state.pos_slots[r] = plen
        state.lengths[r] = plen + 1
        state.budget[r] = plen + int(max_new[i])
        state.done[r] = bool(stop[i]) or int(max_new[i]) <= 1
        state.tok[r] = tok0[i]
    return tok0


def serve_prefill_chunk(
    cfg: ModelConfig,
    params: dict,
    state: ServeState,
    rows: list,
    tokens: np.ndarray,  # [n, Sc] one chunk of the right-padded prompts
    positions: np.ndarray,  # [n, Sc] absolute positions; sentinel past each
    #   prompt and at its final token (that one enters via the first decode)
    chunk_off: int,  # column of the chunk's first token
    reset: bool,  # first chunk: forget the rows' previous occupants
    backend: str = "auto",  # ops/paged_attention.BACKENDS
) -> None:
    """One bounded chunk of a chunked admission. The chunk's KV lands in the
    rows' blocks by a block-indexed scatter, then its queries attend every
    written block in place through the chunked-prefill kernel, each row
    bounded by its written frontier (``nlive``). The rows stay parked
    (done) until ``serve_admit_finish``. On a quantized arena the first
    chunk resets the scales of every block the rows' tables name
    (``serve.py:974-989``), so a previous occupant's larger scale does not
    coarsen this admission's codes."""
    dev = state.k.device
    n, Sc = tokens.shape
    BS = state.block_size
    rows_t = torch.as_tensor(rows, device=dev)
    tbl = state.block_tables[rows_t]
    if reset:
        state.kpos[rows_t] = POS_SENTINEL
        state.out[rows] = 0
        if state.k_scale is not None:
            state.k_scale[:, tbl.long()] = 0.0
            state.v_scale[:, tbl.long()] = 0.0
    pos_t = torch.from_numpy(np.asarray(positions, np.int32)).to(dev)
    kv_pos = state.kpos[rows_t]
    kv_pos[:, chunk_off : chunk_off + Sc] = pos_t
    cols = (chunk_off + torch.arange(Sc, device=dev)).expand(n, Sc)
    nlive = torch.full((n,), -(-(chunk_off + Sc) // BS), dtype=torch.int32, device=dev)
    fns = model_fns(cfg)
    h = fns.embed(cfg, params, torch.from_numpy(tokens).to(dev), pos_t)
    fns.stage_paged(
        cfg, params["layers"], h, state.k, state.v, tbl, cols, kv_pos, pos_t,
        prefill=True, nlive=nlive, k_scale=state.k_scale, v_scale=state.v_scale,
        backend=backend,
    )
    state.kpos[rows_t] = kv_pos
    state.write_off[rows] = chunk_off + Sc
    state.out[rows, chunk_off : chunk_off + Sc] = tokens


def serve_admit_finish(
    state: ServeState,
    rows: list,
    last_tok: np.ndarray,  # [n] each row's final real prompt token
    prompt_len: np.ndarray,
    max_new: np.ndarray,
    seeds: np.ndarray,
    temps: np.ndarray,
    topks: np.ndarray,
    topps: np.ndarray,
) -> None:
    """Arm chunk-prefilled rows: the final prompt token becomes each row's
    next input at position ``prompt_len - 1``; the first decode step
    computes it and samples the first generated token."""
    _arm_sampling(state, rows, seeds, temps, topks, topps)
    for i, r in enumerate(rows):
        plen = int(prompt_len[i])
        state.pos_slots[r] = plen - 1
        state.lengths[r] = plen
        state.budget[r] = plen + int(max_new[i])
        state.done[r] = int(max_new[i]) < 1
        state.tok[r] = last_tok[i]


def serve_step(
    cfg: ModelConfig, params: dict, state: ServeState, rows: list, backend: str = "auto"
) -> np.ndarray:
    """One decode step for the live ``rows``: feed each row's next token,
    write its KV at the row's write column (quantized against the running
    block scale on an int8/fp8 arena), attend the row's blocks through the
    paged decode kernel, commit the sampled token. Returns the tokens."""
    dev = state.k.device
    n = len(rows)
    rows_t = torch.as_tensor(rows, device=dev)
    pos = state.pos_slots[rows].astype(np.int32)
    cols = state.write_off[rows]
    pos_t = torch.from_numpy(pos[:, None]).to(dev)
    cols_t = torch.from_numpy(cols[:, None]).to(dev)
    kv_pos = state.kpos[rows_t]
    kv_pos[torch.arange(n, device=dev), cols_t[:, 0]] = pos_t[:, 0]
    fns = model_fns(cfg)
    h = fns.embed(cfg, params, torch.from_numpy(state.tok[rows][:, None]).to(dev), pos_t)
    h = fns.stage_paged(
        cfg, params["layers"], h, state.k, state.v, state.block_tables[rows_t], cols_t,
        kv_pos, pos_t, k_scale=state.k_scale, v_scale=state.v_scale, backend=backend,
    )
    logits = fns.final_logits(cfg, params, h)[:, 0]
    nxt = _sample_rows(state, rows, logits)
    state.kpos[rows_t] = kv_pos
    state.write_off[rows] += 1
    state.pos_slots[rows] += 1
    stop = _stop_mask(cfg, nxt)
    for i, r in enumerate(rows):
        state.out[r, state.lengths[r]] = nxt[i]
        state.lengths[r] += 1
        state.done[r] = bool(stop[i]) or state.lengths[r] >= state.budget[r]
        state.tok[r] = nxt[i]
    return nxt


def serve_cancel_rows(state: ServeState, rows: list) -> None:
    """Stop rows: they take no further decode steps."""
    state.done[rows] = True
    for r in rows:
        state.rng[r] = None

