"""Operator commands of the port (counterpart of ``llm_sharding_tpu/cli.py``).

    python -m llm_sharding_tpu_torch generate STORE --prompt TEXT [--max-new N] [--stream]
    python -m llm_sharding_tpu_torch serve STORE [--capacity C] [--batch-per-slot M] \
        [--kv-block-size BS --kv-blocks NB] [--http-port P] [--metrics-port Q] ...
    python -m llm_sharding_tpu_torch convert MODEL_DIR OUT_DIR \
        [--dtype bf16|f32|int8|int4] [--quantize-head]
    python -m llm_sharding_tpu_torch trace-report FILES... [--top N] [--trace ID] [--json]
    python -m llm_sharding_tpu_torch step-report FILES... [--top N] [--json]
    python -m llm_sharding_tpu_torch launch STORE --processes N --prompt TEXT [--max-new N]
    python -m llm_sharding_tpu_torch worker STORE --coordinator HOST:PORT --processes N \
        --process-id I --prompt TEXT
    python -m llm_sharding_tpu_torch profile (--preset NAME | --shards STORE) [--out DIR] \
        [--dtype bf16] [--decode-tokens 64] [--hops N] [--cold-start] [--hbm-gib G] \
        [--suggest-stages N]
    python -m llm_sharding_tpu_torch lint [--rule RULE] [--json] [--baseline FILE] \
        [--write-baseline]

``generate`` runs one text prompt (``cli.py:157``; ``--stream`` through a
shared server). ``serve`` is the daemon (``cli.py:433-1094``): one text prompt per stdin line, its
completion streamed to stdout; the control lines ``:counters``,
``:stats``, ``:snapshot DIR``, ``:profile N [DIR]`` and ``:placement``
(hot repartition); ``--http-port`` starts the HTTP/SSE ingress with
tenant fairness (``runtime/ingress.py``; ``--tenants-config``),
``--metrics-port`` the ``/metrics`` exposition, and SIGTERM drains: new
HTTP requests are shed with 503, live ones finish, the daemon exits 0. A
store without a tokenizer still serves: HTTP takes token-id prompts and
stdin lines are refused one by one. ``--data-parallel N`` serves N
replicas behind the supervised router (``runtime/replicated.py``), with ``:drain N`` and ``:spawn``, ``--autoscale``
and ``--disagg`` prefill/decode roles (``runtime/disagg.py``;
``--prefill-replicas``, ``--roles``, ``--profile-json``). ``--stages N``
/ ``--ranges a:b,...`` cut the model into pipeline stages
(``parallel/placement.py``), ``--tensor-parallel T`` shards each stage,
``--cp N`` splits the paged arena over N shards (context-parallel
serving). Both commands run on the GPU unless ``--device cpu`` is given
(the one flag the JAX parser lacks): the one device runs every stage,
shard and replica. A store without a tokenizer takes ``--prompt-ids``
(comma-separated token ids) and prints the generated ids.

``worker`` / ``launch`` (``cli.py:1125``, ``:1162``) run the model as one
OS process per pipeline stage, the reference's ring: each rank joins a
``torch.distributed`` group over ``gloo`` (``parallel/distributed.py``;
the one backend that puts several ranks on one GPU, named by every rank),
loads its stage's layers only, and passes the hidden state on; the last
rank's token goes back to rank 0, which prints the completion, the text
of the one-process ``generate``. ``launch`` spawns the N workers on this
host with their logs in ``--log-dir/worker_<i>.log``.

``convert`` turns an HF checkpoint directory into a shard store either
package serves (``cli.py:129-154``, ``:1468-1478``): ``--dtype int8`` /
``int4`` store the layers' matmul weights quantized with bf16 scales
(int4 packs two values per byte on disk), ``--quantize-head`` the vocab
tables too. ``trace-report`` and ``step-report`` (``cli.py:1364``,
``:1402``, parser ``:1899-1944``: the same flags and output) render span
files and step-profiler captures of either package; they need no GPU, no
model and no torch (``obs/report.py``).

``profile`` (``cli.py:1288``, parser ``:1870-1894``: the same flags) runs
the capability profiler (``profiler/``) on one model, a store or a preset
with random weights, and writes ``profile.json``; ``lint`` (``:1435``,
parser ``:1946-1975``) runs shardlint's lock-order, metrics and trace rules
over this package (``analysis/``), with no torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import signal
import sys
import threading

import numpy as np

# names of torch dtypes: torch is imported by the commands that need it,
# so the report commands run where it is not installed
DTYPES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f32": "float32", "float32": "float32",
    "f16": "float16", "float16": "float16",
}


def _dtype(name: str):
    import torch

    if name not in DTYPES:
        hint = (
            f" ({name} is a convert-time option; {name} stores load with "
            "any compute dtype — pass e.g. --dtype bf16)"
            if name in ("int8", "int4") else ""
        )
        raise SystemExit(f"unknown dtype {name!r}; choose from {sorted(set(DTYPES))}{hint}")
    return getattr(torch, DTYPES[name])


def _stdin_lines(stop_evt):
    """Prompt lines from stdin, waking every 200 ms to honor a SIGTERM
    (``stop_evt``) while blocked on input (JAX ``cli.py:42``). Stdin that is
    not selectable (a test's ``StringIO``) is iterated plainly. The select
    path reads the fd raw and splits lines itself: a buffered
    ``readline`` would strand the second line of a burst in Python's
    read-ahead buffer, which select never sees."""
    try:
        fd = sys.stdin.fileno()
        import select as _select

        _select.select([fd], [], [], 0)
    except Exception:  # noqa: BLE001 — no real fd / select unsupported
        yield from sys.stdin
        return
    buf = ""
    while not stop_evt.is_set():
        r, _, _ = _select.select([fd], [], [], 0.2)
        if not r:
            continue
        chunk = os.read(fd, 65536)
        if not chunk:  # EOF (^D / closed pipe)
            if buf:
                yield buf
            return
        buf += chunk.decode("utf-8", errors="replace")
        while "\n" in buf:
            line, buf = buf.split("\n", 1)
            yield line + "\n"


def _parse_ranges(text: str):
    ranges = []
    for part in text.split(","):
        a, b = part.split(":")
        ranges.append((int(a), int(b)))
    return ranges


def _placement(args, num_layers: int):
    from .parallel.placement import PlacementSpec

    if getattr(args, "ranges", None):
        return PlacementSpec.from_ranges(_parse_ranges(args.ranges), num_layers)
    if getattr(args, "stages", None):
        return PlacementSpec.balanced(num_layers, args.stages)
    return None


def _engine(args):
    """The engine of ``--stages`` / ``--ranges`` / ``--tensor-parallel`` on
    ``--device`` (JAX ``cli.py:115``): with any of them, the store loads
    into host memory and every stage (and every tensor shard) runs on the
    one device, listed ``tp`` times per layer so that a later
    ``:placement`` runs ungrouped; without, the weights load straight onto
    the device as one stage (the daemon's first ``:placement`` then takes
    the host copy, ``_apply_placement``)."""
    from .runtime.engine import Engine
    from .utils import shard_store

    cfg = shard_store.load_config(args.shards)
    L = cfg.num_hidden_layers
    placement = _placement(args, L)
    tp = getattr(args, "tensor_parallel", 1)
    cp = getattr(args, "cp", 1)
    if placement is None and tp == 1 and cp == 1:
        return Engine.from_shards(args.shards, dtype=_dtype(args.dtype), device=args.device)
    # --cp N: the server's cp × stages grid comes from the engine's devices
    return Engine.from_shards(args.shards, dtype=_dtype(args.dtype), placement=placement,
                              num_stages=None if placement else 1,
                              devices=[args.device] * (L * tp * cp), tensor_parallel=tp)


def _prompt_ids(text: str) -> np.ndarray:
    """``--prompt-ids``: comma-separated token ids."""
    return np.asarray([int(t) for t in text.split(",") if t.strip()], np.int32)


def _ids_text(ids) -> str:
    """Generated ids as ``--prompt-ids`` prints them."""
    return " ".join(str(int(t)) for t in ids)


def cmd_generate(args) -> int:
    """One prompt (JAX ``cli.py:157``): the completion, or with ``--stream``
    its deltas as they commit through a shared server. ``--prompt-ids``
    (a store without a tokenizer): the generated ids."""
    eng = _engine(args)
    if args.prompt_ids is not None:
        p = _prompt_ids(args.prompt_ids)
        res = eng.generate_ids(p, args.max_new, temperature=args.temperature, top_k=args.top_k,
                               top_p=args.top_p, seed=args.seed)
        print(_ids_text(res.tokens[0, len(p) : int(res.lengths[0])]))
        return 0
    if args.stream:
        for delta in eng.generate_text_stream(
            args.prompt, args.max_new, temperature=args.temperature, seed=args.seed,
            top_k=args.top_k, top_p=args.top_p,
        ):
            print(delta, end="", flush=True)
        print()
    else:
        print(eng.generate_text(
            args.prompt, args.max_new, temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed,
        ))
    return 0


def _serve_control(eng, srv, line: str, args):
    """The daemon's control lines (JAX ``cli.py:179-352``): ``:counters``,
    ``:stats`` (counters, every registry metric and the step profiler's
    aggregates as one JSON line), ``:snapshot DIR`` (``serve --restore
    DIR`` resumes it), ``:profile N [DIR]`` (an N-step deep capture; with
    DIR a ``torch.profiler`` trace as well), each printed to stderr, and
    ``:placement 0:6,6:28`` / ``:placement N`` (``_apply_placement``).
    Returns the server, a new one after a placement."""
    from .obs.metrics import REGISTRY

    parts = line.split(None, 1)
    cmd = parts[0]
    if cmd == ":counters":
        print(json.dumps(srv.counters.snapshot()), file=sys.stderr)
    elif cmd == ":stats":
        stats = {
            "counters": srv.counters.snapshot(),
            "metrics": REGISTRY.json_snapshot(),
            "stepline": srv.stepline_stats(),
        }
        pc = srv.prefix_cache_stats()
        if pc is not None:
            stats["prefix_cache"] = pc
        print(json.dumps(stats, sort_keys=True), file=sys.stderr)
    elif cmd == ":profile":
        sub = parts[1].split() if len(parts) > 1 else []
        if not sub:
            print("usage: :profile N [TRACE_DIR]", file=sys.stderr)
            return srv
        try:
            bundle = srv.stepline_capture(int(sub[0]), trace_dir=sub[1] if len(sub) > 1 else None)
        except ValueError as e:
            print(f"profile failed: {e}", file=sys.stderr)
            return srv
        print(json.dumps(bundle, sort_keys=True), file=sys.stderr)
    elif cmd == ":snapshot":
        if len(parts) < 2:
            print("usage: :snapshot DIR", file=sys.stderr)
            return srv
        from .runtime.server import save_snapshot

        try:
            save_snapshot(srv.snapshot(), parts[1])
            print(f"snapshot written to {parts[1]}", file=sys.stderr)
        except (ValueError, RuntimeError, OSError) as e:
            print(f"snapshot failed: {e}", file=sys.stderr)
    elif cmd == ":placement":
        return _apply_placement(eng, srv, parts, args)
    else:
        print(f"unknown control line {cmd!r} (try :placement, :counters, :stats, :snapshot, "
              ":profile)", file=sys.stderr)
    return srv


def _apply_placement(eng, srv, parts: list, args):
    """``:placement 0:6,6:28`` (ragged ranges) or ``:placement N``
    (balanced), JAX ``cli.py:253-347``: drain the requests in flight,
    apply the placement, rebuild the server on it with the live server's
    options and carry the session counters over. A bad placement keeps the
    old one serving; a rebuild that fails rolls the placement back; if the
    rollback fails too, the daemon prints its totals and exits 1."""
    import collections

    from .parallel.placement import PlacementSpec

    if len(parts) < 2:
        print("usage: :placement 0:6,6:32  |  :placement N", file=sys.stderr)
        return srv
    num_layers = eng.cfg.num_hidden_layers
    old_spec = eng.placement
    try:
        if ":" in parts[1]:
            spec = PlacementSpec.from_ranges(_parse_ranges(parts[1]), num_layers)
        else:
            spec = PlacementSpec.balanced(num_layers, int(parts[1]))
        srv.run_until_idle()
        counters = srv.counters
        if not eng.host_staged:  # loaded straight onto the device: copy it to the host once
            eng.keep_host_copy([args.device] * num_layers)
        eng.apply_placement(spec)
    except (ValueError, KeyError) as e:
        print(f"bad placement: {e}", file=sys.stderr)
        return srv

    def build():
        # every option from the LIVE server: a --restore'd daemon's came
        # from its snapshot, not from the command line
        return eng.serve(
            capacity=srv.capacity, batch_per_slot=srv.batch_per_slot,
            chunk_cycles=srv.chunk_cycles, prefill_chunk=srv.prefill_chunk,
            pipeline_depth=srv.pipeline_depth, inflight_steps=srv.inflight_steps,
            top_k=srv.top_k, top_p=srv.top_p, trace_path=getattr(args, "trace_path", None),
            speculate=srv.speculate, spec_ngram=srv.spec_ngram, max_queue=srv.max_queue,
            default_deadline_s=srv.default_deadline_s, snapshot_every_s=srv._snapshot_every_s,
            snapshot_path=srv._snapshot_path, kv_block_size=srv.kv_block_size,
            kv_blocks=srv.kv_blocks, kv_dtype=srv.kv_dtype, paged_attn=srv.paged_attn,
            prefix_cache=srv.prefix_cache,
            host_pool_blocks=(srv.host_pool_blocks
                              if srv.prefix_cache in ("host", "disk") else 0),
            disk_pool_dir=srv.disk_pool_dir, disk_pool_blocks=srv.disk_pool_blocks,
            gauge_sweep_every_s=srv.gauge_sweep_every_s,
        )

    try:
        new_srv = build()
        applied = spec
    except Exception as e:  # noqa: BLE001 — keep the daemon alive
        # the old server reads the engine's swapped stages no more, but its
        # arenas are sized for them: roll the placement back and rebuild
        try:
            eng.apply_placement(old_spec)
            new_srv = build()
        except Exception as e2:  # noqa: BLE001
            print(json.dumps(counters.snapshot()), file=sys.stderr)
            print(f"placement rebuild failed ({e}) and rollback to {list(old_spec.stages)} "
                  f"also failed ({e2}); daemon state is unrecoverable, exiting",
                  file=sys.stderr)
            raise SystemExit(1)
        applied = old_spec
        print(f"placement rebuild failed ({e}); rolled back to {list(old_spec.stages)}",
              file=sys.stderr)
    srv.close()
    new_srv.counters = counters  # session totals survive the swap
    # the JAX line names the mesh's shape, an OrderedDict of its one axis
    shape = collections.OrderedDict(pipe=eng.num_stages)
    print(f"placement applied: {list(applied.stages)} over {shape}", file=sys.stderr)
    return new_srv


def _dp_serve_control(srv, line: str) -> None:
    """The replicated daemon's control lines (JAX ``cli.py:354-432``):
    ``:drain N`` migrates every live request off replica N and closes it
    (refused below ``--min-replicas``), ``:spawn`` brings a replica up on
    the lowest freed group, ``:counters`` / ``:stats`` (the router's view:
    per-replica health, load and KV, plus every registry metric) and
    ``:profile N [DIR]`` (the capture fan-out over every replica)."""
    from .obs.metrics import REGISTRY

    parts = line.split(None, 1)
    cmd = parts[0]
    if cmd == ":counters":
        print(json.dumps(srv.counters.snapshot()), file=sys.stderr)
    elif cmd == ":stats":
        print(json.dumps({**srv.stats(), "metrics": REGISTRY.json_snapshot()}, sort_keys=True),
              file=sys.stderr)
    elif cmd == ":drain":
        if len(parts) < 2:
            print("usage: :drain N  (replica device-group index)", file=sys.stderr)
            return
        try:
            moved = srv.drain(int(parts[1]))
            print(f"replica {int(parts[1])} drained: {moved} request(s) migrated; "
                  f"{len(srv.servers)} replica(s) live", file=sys.stderr)
        except (ValueError, RuntimeError) as e:
            print(f"drain failed: {e}", file=sys.stderr)
    elif cmd == ":spawn":
        try:
            s = srv.spawn_replica()
            print(f"replica spawned on group {srv._group_of[s]}; {len(srv.servers)} "
                  "replica(s) live", file=sys.stderr)
        except (ValueError, RuntimeError) as e:
            print(f"spawn failed: {e}", file=sys.stderr)
    elif cmd == ":profile":
        sub = parts[1].split() if len(parts) > 1 else []
        if not sub:
            print("usage: :profile N [TRACE_DIR]", file=sys.stderr)
            return
        try:
            bundle = srv.stepline_capture(int(sub[0]), trace_dir=sub[1] if len(sub) > 1 else None)
        except ValueError as e:
            print(f"profile failed: {e}", file=sys.stderr)
            return
        print(json.dumps(bundle, sort_keys=True), file=sys.stderr)
    else:
        print(f"unknown control line {cmd!r} (dp daemon: :drain N, :spawn, :counters, "
              ":stats, :profile)", file=sys.stderr)


def _fleet_fast_fail(args) -> str:
    """The fleet flags' checks (JAX ``cli.py:554-640``), in its order and
    with its words; '' when they hold together."""
    if args.autoscale and args.data_parallel < 2:
        return ("--autoscale needs --data-parallel >= 2 (the autoscaler "
                "drives ReplicatedServer drain/spawn between --min-replicas "
                "and the replica count)")
    if (args.prefill_replicas or args.roles or args.profile_json) and not args.disagg:
        return "--prefill-replicas/--roles/--profile-json need --disagg"
    if not args.disagg:
        return ""
    dp = args.data_parallel
    if dp < 2:
        return ("--disagg needs --data-parallel >= 2 (prefill and "
                "decode pools each need at least one replica group)")
    if not args.kv_block_size:
        return ("--disagg needs paged KV serving "
                "(--kv-block-size/--kv-blocks): the hand-off engine "
                "streams arena blocks between replicas")
    if args.prefix_cache == "off":
        return ("--disagg needs --prefix-cache hbm, host or disk: the "
                "hand-off lands streamed KV in the decode replica's radix "
                "tree so adoption skips re-prefill")
    if args.prefill_replicas and args.roles:
        return "--prefill-replicas and --roles are mutually exclusive"
    if args.prefill_replicas and not 1 <= args.prefill_replicas <= dp - 1:
        return (f"--prefill-replicas must be in [1, {dp - 1}] (both sides need at "
                f"least one replica), got {args.prefill_replicas}")
    if args.roles:
        from .obs.metrics import REPLICA_ROLES

        roles = [r.strip() for r in args.roles.split(",")]
        if len(roles) != dp or any(r not in REPLICA_ROLES for r in roles):
            return (f"--roles needs {dp} comma-separated values from {REPLICA_ROLES}, "
                    f"got {args.roles!r}")
    if args.profile_json:
        from .runtime.placement import PlacementPlanner

        try:
            PlacementPlanner.from_json(args.profile_json)
        except (OSError, ValueError, KeyError, TypeError) as e:
            return f"bad --profile-json: {e}"
    return ""


def _fast_fail(args) -> str:
    """The JAX daemon's checks that need no model (``cli.py:439-642``), with
    its messages; '' when the flags hold together."""
    if bool(args.snapshot_every) != bool(args.snapshot_dir):
        return ("--snapshot-every and --snapshot-dir go together "
                f"(got --snapshot-every {args.snapshot_every or 0}, "
                f"--snapshot-dir {args.snapshot_dir!r})")
    if bool(args.kv_block_size) != bool(args.kv_blocks):
        return ("--kv-block-size and --kv-blocks go together "
                f"(got --kv-block-size {args.kv_block_size or 0}, "
                f"--kv-blocks {args.kv_blocks or 0})")
    if args.inflight_steps < 1:
        return f"--inflight-steps must be >= 1, got {args.inflight_steps}"
    if args.paged_attn != "auto" and not args.kv_block_size:
        return (f"--paged-attn {args.paged_attn} needs paged KV serving "
                "(--kv-block-size/--kv-blocks); dense decode has no block "
                "tables to stream")
    if args.kv_dtype != "bf16" and not args.kv_block_size:
        return (f"--kv-dtype {args.kv_dtype} needs paged KV serving "
                "(--kv-block-size/--kv-blocks); quantization scales live per "
                "arena block")
    if args.prefix_cache != "off" and not args.kv_block_size:
        return (f"--prefix-cache {args.prefix_cache} needs paged KV "
                "serving (--kv-block-size/--kv-blocks); the cache shares "
                "refcounted arena blocks")
    if args.host_pool_blocks and args.prefix_cache not in ("host", "disk"):
        return ("--host-pool-blocks sizes the host-RAM tier — it needs "
                f"--prefix-cache host or disk (got --prefix-cache {args.prefix_cache})")
    if args.prefix_cache == "disk" and not args.disk_pool_dir:
        return ("--prefix-cache disk needs --disk-pool-dir (the on-disk "
                "KV pool is the persistent artifact — it must have a home)")
    if (args.disk_pool_dir or args.disk_pool_blocks) and args.prefix_cache != "disk":
        return ("--disk-pool-dir/--disk-pool-blocks configure the disk "
                "KV tier — they need --prefix-cache disk (got --prefix-cache "
                f"{args.prefix_cache})")
    if args.cp > 1:  # JAX cli.py:524-543, the same order and words
        if not args.kv_block_size:
            return ("--cp needs paged KV serving "
                    "(--kv-block-size/--kv-blocks): context parallelism "
                    "shards the paged arena")
        if args.tensor_parallel > 1:
            return "--cp with --tensor-parallel is not supported yet"
        if args.speculate:
            return "--cp with --speculate is not supported yet"
        if args.prefix_cache != "off" and not args.prefill_chunk:
            return ("--cp with --prefix-cache needs --prefill-chunk: "
                    "radix hits admit through the chunked ring-prefill "
                    "path under context parallelism")
    if args.tenants_config and not args.http_port:
        return ("--tenants-config needs --http-port (tenant policy is "
                "enforced at the HTTP ingress; stdin prompts have no tenant)")
    bad = _fleet_fast_fail(args)
    if bad:
        return bad
    if args.tenants_config:
        from .runtime.fairness import load_tenants_config

        try:
            load_tenants_config(args.tenants_config)
        except (OSError, ValueError, TypeError, KeyError) as e:
            return f"bad --tenants-config: {e}"
    return ""


def _serve_kwargs(args) -> dict:
    return dict(
        capacity=args.capacity, batch_per_slot=args.batch_per_slot,
        prefill_chunk=args.prefill_chunk, top_k=args.top_k, top_p=args.top_p,
        trace_path=args.trace_path, speculate=args.speculate, spec_ngram=args.spec_ngram,
        inflight_steps=args.inflight_steps, max_queue=args.max_queue or None,
        default_deadline_s=args.default_deadline or None,
        snapshot_every_s=args.snapshot_every or None, snapshot_path=args.snapshot_dir,
        kv_block_size=args.kv_block_size or None, kv_blocks=args.kv_blocks or None,
        kv_dtype=args.kv_dtype, paged_attn="plain" if args.paged_attn == "xla" else args.paged_attn,
        prefix_cache=args.prefix_cache, host_pool_blocks=args.host_pool_blocks,
        disk_pool_dir=args.disk_pool_dir, disk_pool_blocks=args.disk_pool_blocks,
        gauge_sweep_every_s=args.gauge_sweep_every, cp=args.cp,
    )


def _restore(eng, args):
    """``--restore DIR``: the snapshot's daemon, its requests finished
    first (their clients are gone: the completions go to stdout, one per
    line). The snapshot's serve options win over the flags, and the flags
    that differ are named."""
    from .obs.trace import TraceWriter
    from .runtime.server import PipelineServer, load_snapshot

    srv = PipelineServer.restore(eng, load_snapshot(args.restore))
    if args.snapshot_every or args.snapshot_dir:
        srv.enable_auto_snapshot(args.snapshot_dir, args.snapshot_every or None)
    if args.trace_path:
        srv._trace = TraceWriter(args.trace_path)
    revived = [r for r in srv._req if r is not None and not r.done] + list(srv._queue)
    print(f"restored snapshot from {args.restore}: {len(revived)} live request(s) resume",
          file=sys.stderr)
    kw = _serve_kwargs(args)
    ignored = [
        f"--{flag.replace('_', '-')} {got} (snapshot: {used})"
        for flag, got, used in (
            ("capacity", args.capacity, srv.capacity),
            ("batch_per_slot", args.batch_per_slot, srv.batch_per_slot),
            ("prefill_chunk", args.prefill_chunk, srv.prefill_chunk),
            ("top_k", args.top_k, srv.top_k),
            ("top_p", args.top_p, srv.top_p),
            ("speculate", args.speculate, srv.speculate),
            ("spec_ngram", args.spec_ngram, srv.spec_ngram),
            ("inflight_steps", args.inflight_steps, srv.inflight_steps),
            ("max_queue", kw["max_queue"], srv.max_queue),
            ("default_deadline", kw["default_deadline_s"], srv.default_deadline_s),
            ("kv_block_size", kw["kv_block_size"], srv.kv_block_size),
            ("kv_blocks", kw["kv_blocks"], srv.kv_blocks),
            ("kv_dtype", args.kv_dtype, srv.kv_dtype),
            ("paged_attn", kw["paged_attn"], srv.paged_attn),
            ("prefix_cache", args.prefix_cache, srv.prefix_cache),
            ("host_pool_blocks", args.host_pool_blocks or None, srv.host_pool_blocks or None),
            ("disk_pool_dir", args.disk_pool_dir, srv.disk_pool_dir),
            ("disk_pool_blocks", args.disk_pool_blocks or None, srv.disk_pool_blocks or None),
            ("cp", args.cp, srv.cp),
        )
        if got != used
    ]
    if ignored:
        print("warning: serve flags differ from the snapshot and are ignored (a restored "
              "daemon keeps its snapshot's serve_kwargs): " + ", ".join(ignored),
              file=sys.stderr)
    if revived:
        srv.run_until_idle()
        t = eng._require_tokenizer()
        for r in revived:
            print(t.decode(r.tokens, skip_special_tokens=True), flush=True)
    return srv


def cmd_serve(args) -> int:
    """The daemon (JAX ``cli.py:433``): one prompt per stdin line, its
    completion streamed per line; ``:`` lines are control lines
    (``_serve_control``, ``_dp_serve_control`` with ``--data-parallel``).
    The checks that need no model run first and exit 2, the SIGTERM
    handler is installed before the model loads (and the caller's handler
    restored when the daemon returns)."""
    bad = _fast_fail(args)
    if bad:
        print(f"error: {bad}", file=sys.stderr)
        return 2
    if args.data_parallel > 1 and args.restore:
        # JAX cli.py:664-676: one snapshot per replica has no CLI wiring
        print("--restore with --data-parallel is not supported from the CLI; use "
              "ReplicatedServer.snapshot/restore_into", file=sys.stderr)
        return 2
    # SIGTERM drains: installed before the model loads, so the contract
    # holds from the first moment a supervisor can see the daemon
    term = threading.Event()
    prev = None
    if threading.current_thread() is threading.main_thread():
        try:
            prev = signal.signal(signal.SIGTERM, lambda *_: term.set())
        except (ValueError, OSError):
            pass  # an embedded interpreter without signals
    try:
        return _serve(args, term)
    finally:
        if prev is not None:  # a caller in this process gets its handler back
            signal.signal(signal.SIGTERM, prev)


def _fleet(args):
    """``--data-parallel N``: N replicas behind the supervised router (JAX
    ``cli.py:661-760``), each a chain of ``--stages`` / ``--ranges``
    stages, all on the one ``--device``, the weights loaded once on the
    host; ``--disagg`` gives them prefill/decode roles. Returns the
    router."""
    from .device import resolve_device
    from .utils import shard_store

    dev = resolve_device(args.device)  # no GPU: raise before loading
    cfg = shard_store.load_config(args.shards)
    placement = _placement(args, cfg.num_hidden_layers)
    # every stage and tensor shard of every replica on the one device
    tp = args.tensor_parallel
    per = (placement.num_stages if placement else 1) * tp * args.cp
    devs = [args.device] * (args.data_parallel * per)
    cfg, params = shard_store.load_full(args.shards, dtype=_dtype(args.dtype), device="cpu")
    extra: dict = {}
    if args.disagg:
        from .runtime.disagg import DisaggServer as cls

        roles = [r.strip() for r in args.roles.split(",")] if args.roles else None
        planner = None
        if args.profile_json:
            from .runtime.placement import PlacementPlanner

            planner = PlacementPlanner.from_json(args.profile_json)
        extra = dict(roles=roles, planner=planner,
                     prefill_replicas=args.prefill_replicas or (1 if roles is None else None))
    else:
        from .runtime.replicated import ReplicatedServer as cls
    srv = cls(cfg, params, data_parallel=args.data_parallel, devices=devs, placement=placement,
              tensor_parallel=tp, tokenizer=shard_store.load_tokenizer(args.shards),
              min_replicas=args.min_replicas, **extra, **_serve_kwargs(args))
    s0 = srv.servers[0]
    mode = ("dense" if s0.kv_block_size is None
            else f"paged {s0.kv_blocks} x {s0.kv_block_size}")
    roles = ""
    if args.disagg:
        roles = (" [disagg roles: " + ",".join(srv.roles[d] for d in sorted(srv.roles))
                 + (", planner: profile.json fits" if srv.planner is not None
                    else ", planner: none (load routing)") + "]")
    print(f"serving {cfg.model_type}: {args.data_parallel} replicas on {dev} "
          f"(capacity={s0.capacity}, rows={s0.rows}, {mode}){roles}; enter a prompt, ^D to "
          "exit; :drain N / :spawn resize the replica set live", file=sys.stderr)
    return srv


def _start_autoscaler(args, srv, ingress, term: threading.Event):
    """``--autoscale`` (JAX ``cli.py:934-976``): the controller ticks from
    the ingress's own thread, with the fair-queue backlog in its load
    signal, or without ``--http-port`` from a thread of its own."""
    import time

    from .runtime.autoscale import Autoscaler

    scaler = Autoscaler(
        srv, min_replicas=args.min_replicas, scale_up_load=args.autoscale_up_load,
        scale_down_load=args.autoscale_down_load, up_after_s=args.autoscale_up_after,
        down_after_s=args.autoscale_down_after, cooldown_s=args.autoscale_cooldown,
        rebalance_every_s=args.rebalance_every,
        extra_load=(lambda: ingress.fair.depth()) if ingress is not None else None,
    )
    if ingress is not None:
        ingress.attach_autoscaler(scaler)
    else:
        def tick_forever():
            while not term.is_set():
                try:
                    scaler.tick()
                except Exception as e:  # noqa: BLE001 — policy errors never kill the daemon
                    print(f"autoscale tick failed: {e}", file=sys.stderr)
                time.sleep(0.25)

        threading.Thread(target=tick_forever, daemon=True, name="autoscale-tick").start()
    print(f"autoscale: replicas in [{scaler.min_replicas}, {scaler.max_replicas}], up at "
          f"load >= {scaler.scale_up_load:g}, down at <= {scaler.scale_down_load:g}",
          file=sys.stderr)
    return scaler


def _serve(args, term: threading.Event) -> int:
    """The daemon's body once its flags hold together (``cmd_serve``)."""
    from .runtime.server import QueueFull, RequestFailed, ServerClosed

    from .ops.kernels import launch_counts as kernel_launches
    from .runtime.engine import text_deltas

    fleet = args.data_parallel > 1
    if fleet:
        srv = _fleet(args)
        eng = srv.engines[0]
    else:
        eng = _engine(args)
        srv = _restore(eng, args) if args.restore else eng.serve(**_serve_kwargs(args))
        mode = ("dense" if srv.kv_block_size is None
                else f"paged {srv.kv_blocks} x {srv.kv_block_size}")
        stages = f"{eng.num_stages} stages from " if eng.num_stages > 1 else ""
        if eng.tensor_parallel > 1:
            stages = f"{stages}{eng.tensor_parallel} tensor shards each from "
        if srv.cp > 1:
            mode = f"{mode} per shard, {srv.cp} context-parallel shards"
        print(f"serving {eng.cfg.model_type} on {stages}{eng.device} (capacity={srv.capacity}, "
              f"rows={srv.rows}, {mode}); enter a prompt, ^D to exit", file=sys.stderr)
    ingress = None
    metrics_srv = _start_metrics(
        args.metrics_port,
        statz_extra={
            "counters": lambda: srv.counters.snapshot(),
            "stepline": lambda: srv.stepline_stats(),
            # each CUDA kernel's launches in this process (0 on the CPU)
            "kernels": kernel_launches,
            **({"replicas": lambda: srv.stats()["replicas"]} if fleet else {}),
        },
        health=lambda: ingress.health if ingress is not None else srv.health,
        profilez=lambda steps, wait_s: (
            srv.stepline_capture(steps, wait_s) if steps is not None
            else {"stepline": srv.stepline_stats(), "steps": srv.stepline_snapshot(64)}
        ),
    )
    # a store without a tokenizer still serves: HTTP takes token ids and
    # stdin prompts are refused one by one
    try:
        tok = eng._require_tokenizer()
    except ValueError:
        tok = None
    if args.http_port:
        from .runtime.ingress import start_ingress

        ingress = start_ingress(
            srv, port=args.http_port, tokenizer=tok, tenants=args.tenants_config,
            max_queue=args.max_queue or None, model_name=eng.cfg.model_type,
            trace_path=args.trace_path, on_error=lambda msg: print(msg, file=sys.stderr),
        )
        if ingress is not None:
            print(f"ingress: http://127.0.0.1:{ingress.port}/v1/completions "
                  f"(tenants: {', '.join(ingress.fair.tenants())})", file=sys.stderr)
    if args.autoscale:
        _start_autoscaler(args, srv, ingress, term)
    n_prompt = 0
    for line in _stdin_lines(term):
        prompt = line.rstrip("\n")
        if not prompt:
            continue
        if prompt.startswith(":"):
            if fleet:
                _dp_serve_control(srv, prompt)
                continue
            # a repartition swaps the engine's stages: the ingress's pump
            # pauses and then points at the rebuilt server (JAX cli.py:985-1006)
            freeze = ingress is not None and prompt.split()[0] == ":placement"
            if freeze:
                ingress.pause()
            try:
                srv = _serve_control(eng, srv, prompt, args)
            finally:
                if freeze:
                    ingress.backend = srv
                    ingress.resume()
            continue
        if tok is None:
            print("rejected: this store has no tokenizer — text prompts need one (the "
                  "HTTP ingress still accepts token-id prompts)", file=sys.stderr)
            continue
        ids = np.asarray(tok(prompt)["input_ids"], np.int32)
        try:
            # each prompt's seed advances from --seed
            req = srv.submit(ids, args.max_new, temperature=args.temperature,
                             seed=args.seed + n_prompt, stop=args.stop)
        except (QueueFull, ServerClosed, ValueError) as e:
            print(f"rejected: {e}", file=sys.stderr)
            continue
        n_prompt += 1
        try:
            for delta in text_deltas(tok, srv.stream(req)):
                print(delta, end="", flush=True)
        except RequestFailed as e:
            print(f"\n[request failed: {e.__cause__ or e}]", file=sys.stderr)
        print(flush=True)
    if term.is_set():
        # SIGTERM drains (JAX cli.py:1045-1062): new HTTP requests are shed
        # with 503, live ones finish, an armed snapshot dir gets a final
        # checkpoint, and the exit code is 0
        print("SIGTERM: draining (new requests shed with 503)", file=sys.stderr)
        if ingress is not None:
            ingress.begin_drain()
        try:
            srv.run_until_idle()  # finish the requests in flight
        except Exception as e:  # noqa: BLE001 — drain anyway
            print(f"drain pump failed: {e}", file=sys.stderr)
        if ingress is not None and not ingress.wait_idle(timeout_s=args.drain_grace):
            print("warning: drain grace expired with streams still live — raise "
                  "--drain-grace to let long completions finish", file=sys.stderr)
        if args.snapshot_dir and not fleet:  # a fleet's snapshot is one per replica
            from .runtime.server import save_snapshot

            try:
                save_snapshot(srv.snapshot(), args.snapshot_dir)
                print(f"final snapshot written to {args.snapshot_dir}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 — a failed final snapshot
                # must not turn a graceful drain into rc != 0
                print(f"final snapshot failed: {e}", file=sys.stderr)
        print("drained; exiting 0", file=sys.stderr)
    print(json.dumps(srv.counters.snapshot()), file=sys.stderr)
    if ingress is not None:
        ingress.stop()
    if metrics_srv is not None:
        metrics_srv.stop()
    srv.close()
    return 0


def _start_metrics(port, statz_extra=None, health=None, profilez=None):
    """The ``/metrics``, ``/statz``, ``/profilez`` and ``/healthz`` thread
    when a port is given (JAX ``cli.py:1095``); a bind failure is reported
    and the daemon serves without it."""
    if not port:
        return None
    from .obs.http import MetricsServer

    try:
        ms = MetricsServer(port=port, statz_extra=statz_extra, health_provider=health)
        if profilez is not None:
            ms.set_profilez_provider(profilez)
        ms.start()
    except OSError as e:
        print(f"metrics endpoint disabled: {e}", file=sys.stderr)
        return None
    print(f"metrics: http://127.0.0.1:{ms.port}/metrics (Prometheus), /statz (JSON), "
          "/profilez (step capture)", file=sys.stderr)
    return ms


def cmd_worker(args) -> int:
    """One process of the ring (JAX ``cli.py:1125``, after the reference's
    ``start_node.py``): joins the ``torch.distributed`` group over gloo
    (named explicitly: several ranks may share one GPU), loads its stage's layers only (``--ranges``, else
    the layers balanced over the ranks), runs ``ring_generate`` with its
    neighbours, and rank 0 prints the completion: the text (or with
    ``--prompt-ids`` the ids) of the one-process ``generate``."""
    import torch

    from .device import resolve_device
    from .parallel.distributed import StageTransport, initialize_multihost, ring_generate
    from .parallel.placement import PlacementSpec
    from .utils import shard_store

    if args.cp > 1:  # JAX server.py:1267-1270: no per-shard push across processes
        print("error: cp > 1 on a multi-controller mesh: the per-shard "
              "block-table push is single-controller for now", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)  # no GPU: raise before joining
    initialize_multihost(args.coordinator, args.processes, args.process_id,
                         backend="gloo")
    try:
        print(f"[worker {args.process_id}] joined: {args.processes} processes over "
              f"gloo, device {dev}", file=sys.stderr)
        metrics_srv = _start_metrics(
            args.metrics_port + args.process_id if args.metrics_port else 0
        )
        cfg = shard_store.load_config(args.shards)
        L = cfg.num_hidden_layers
        spec = (PlacementSpec.from_ranges(_parse_ranges(args.ranges), L) if args.ranges
                else PlacementSpec.balanced(L, args.processes))
        if spec.num_stages != args.processes:
            print(f"error: {spec.num_stages} stages for {args.processes} processes "
                  "(one stage per process)", file=sys.stderr)
            return 2
        lo, hi = spec.stages[args.process_id]
        dtype = getattr(torch, DTYPES[args.dtype])
        stage = shard_store.load_stage(args.shards, lo, hi, dtype, device=dev)
        tok = None
        if args.prompt_ids is not None:
            ids = _prompt_ids(args.prompt_ids)
        else:
            tok = shard_store.load_tokenizer(args.shards)
            if tok is None:
                print("error: the store has no tokenizer: pass --prompt-ids", file=sys.stderr)
                return 2
            ids = np.asarray(tok(args.prompt)["input_ids"], np.int32)
        transport = StageTransport(dev, cfg.hidden_size, dtype)
        out = ring_generate(cfg, stage, ids, args.max_new, transport)
        print(f"[worker {args.process_id}] layers [{lo}, {hi}): {transport.hops} hops, "
              f"{transport.bytes} bytes sent", file=sys.stderr)
        if args.process_id == 0:
            print(_ids_text(out) if tok is None else tok.decode(out, skip_special_tokens=True),
                  flush=True)
        if metrics_srv is not None:
            metrics_srv.stop()
        return 0
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def cmd_launch(args) -> int:
    """Spawn ``--processes`` workers on this host and wait (JAX
    ``cli.py:1162``, after the reference's ``run_this.sh``): rank 0's
    completion goes to stdout, every worker's output into
    ``--log-dir/worker_<i>.log``. A worker that fails stops the job, as
    does ``--timeout``. Every rank runs on ``--device`` (default cuda: all
    ranks on the one card) unless ``--platform cpu`` asks for the CPU."""
    import contextlib
    import socket
    import subprocess
    import time

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    device = "cpu" if args.platform == "cpu" else args.device
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    # every rank is on this host: gloo talks over the loopback interface
    # (its default, the host name's interface, may not reach itself on a
    # machine without a network)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.makedirs(args.log_dir, exist_ok=True)
    rc = 0
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        procs, logs = [], []
        for pid in range(args.processes):
            cmd = [
                sys.executable, "-m", "llm_sharding_tpu_torch", "worker", args.shards,
                "--coordinator", f"localhost:{port}", "--processes", str(args.processes),
                "--process-id", str(pid), "--max-new", str(args.max_new),
                "--dtype", args.dtype, "--device", device,
            ]
            cmd += (["--prompt-ids", args.prompt_ids] if args.prompt_ids is not None
                    else ["--prompt", args.prompt])
            if args.ranges:
                cmd += ["--ranges", args.ranges]
            if args.metrics_port:
                cmd += ["--metrics-port", str(args.metrics_port)]
            log_path = os.path.join(args.log_dir, f"worker_{pid}.log")
            logs.append(log_path)
            log = stack.enter_context(open(log_path, "w"))
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE if pid == 0 else log, stderr=log,
                                 text=True, env=env)
            stack.callback(lambda p=p: p.poll() is None and p.kill())
            procs.append(p)
        # rank 0's stdout drains on a thread: a completion larger than the
        # pipe buffer would otherwise block the worker
        out0: list = []
        drain0 = threading.Thread(target=lambda: out0.append(procs[0].stdout.read()),
                                  daemon=True)
        drain0.start()
        deadline = time.monotonic() + args.timeout if args.timeout else None
        failed = None
        while any(p.poll() is None for p in procs):
            failed = next(((i, p.returncode) for i, p in enumerate(procs)
                           if p.poll() is not None and p.returncode != 0), None)
            if failed or (deadline and time.monotonic() > deadline):
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                if failed is None:
                    print(f"launch timed out after {args.timeout}s; workers terminated",
                          file=sys.stderr)
                break
            time.sleep(0.05)
        for pid, p in enumerate(procs):
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.returncode != 0:
                rc = rc or p.returncode or 1
                print(f"worker {pid} exited {p.returncode}; see {logs[pid]}", file=sys.stderr)
        drain0.join(timeout=10)
        if out0 and out0[0]:
            print(out0[0], end="")
    print(f"launch: {args.processes} workers in {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    return rc


def cmd_convert(args) -> int:
    from .utils.shard_store import convert_hf_checkpoint

    if args.dtype in ("int8", "int4"):
        dtype, quantize = _dtype("bf16"), True
        bits = 8 if args.dtype == "int8" else 4
    else:
        dtype, quantize, bits = _dtype(args.dtype), False, 8
    if args.quantize_head and not quantize:
        raise SystemExit("--quantize-head requires --dtype int8 or int4")
    cfg = convert_hf_checkpoint(
        args.model_dir, args.out_dir, dtype, quantize=quantize,
        quantize_head=args.quantize_head, quant_bits=bits,
    )
    print(
        f"converted {cfg.model_type} ({cfg.num_hidden_layers} layers, "
        f"vocab {cfg.vocab_size}{f', {args.dtype}' if quantize else ''}"
        f"{' incl. head' if args.quantize_head else ''}) "
        f"-> {args.out_dir}"
    )
    return 0


def _expand(patterns) -> list:
    """Command-line files, globs expanded (sorted), the rest as given."""
    paths = []
    for pat in patterns:
        paths.extend(sorted(glob.glob(pat)) if any(c in pat for c in "*?[") else [pat])
    return paths


def cmd_trace_report(args) -> int:
    """Merge JSONL trace files, rebuild the span trees, and print per-phase
    latency attribution (``obs/report.py``; JAX ``cli.py:1364``)."""
    from .obs.report import load_events, render_report, report_json, trace_json

    paths = _expand(args.files)
    if not paths:
        print("no trace files matched", file=sys.stderr)
        return 2
    try:
        events = load_events(paths)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not events:
        print("no span events in the input files", file=sys.stderr)
        return 1
    if args.json and args.trace is not None:
        out = trace_json(events, args.trace)
        print(json.dumps(out, sort_keys=True))
        return 0 if out["found"] else 1
    if args.json:
        print(json.dumps(report_json(events, top=args.top), sort_keys=True))
    else:
        print(render_report(events, top=args.top, trace_id=args.trace))
    return 0


def cmd_step_report(args) -> int:
    """Render step-profiler captures offline: ``/profilez`` bundles,
    ``/debugz`` postmortems and raw record lists merged into the per-phase
    host-time attribution, occupancy timeline and worst device bubbles
    (``obs/report.py``; JAX ``cli.py:1402``)."""
    from .obs.report import load_steps, render_step_report, step_report_json

    paths = [p for p in _expand(args.files) if os.path.exists(p)]
    if not paths:
        print("no capture files matched", file=sys.stderr)
        return 2
    steps = load_steps(paths)
    if not steps:
        print("no step records in the input files", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(step_report_json(steps, top=args.top), sort_keys=True))
    else:
        print(render_step_report(steps, top=args.top))
    return 0


def cmd_profile(args) -> int:
    """Capability sweeps of one model on ``--device`` and their artifacts
    (JAX ``cli.py:1288``): the prefill sweep, the decode curve, the
    similarity verdict, optionally the hop latency, the cold start, the
    layers that fit and a capability-weighted placement; ``profile.json``
    under ``--out`` and the payload on stdout."""
    from .device import resolve_device
    from .profiler.artifacts import save_profile_artifacts
    from .profiler.profiler import (
        Profiler, detect_hbm_bytes, max_layers_fit, measure_hop_latency, profile_cold_start,
    )

    device = resolve_device(args.device)
    dtype = _dtype(args.dtype)
    cold = None
    if args.shards:
        from .utils import shard_store

        cfg, params = shard_store.load_full(args.shards, dtype=dtype, device=device)
        if args.cold_start:
            cold = profile_cold_start(args.shards, dtype=dtype, device=device)
    else:
        from .models import config as config_mod

        cfg = getattr(config_mod, args.preset)()
        if cfg.model_type == "llama":
            from .models import llama as model_mod
        elif cfg.model_type == "gpt2":
            from .models import gpt2 as model_mod
        else:
            raise SystemExit(
                f"preset {args.preset!r} has unsupported model_type "
                f"{cfg.model_type!r} for random-weight profiling"
            )
        params = model_mod.init_params(cfg, seed=0, dtype=dtype, device=device)

    prof = Profiler(cfg, params, dtype=dtype)
    prefill = prof.profile_prefill()
    decode = prof.profile_decode(max_tokens=args.decode_tokens)
    verdict = Profiler.similarity_verdict(prefill, decode)

    hop = None
    if args.hops:
        from .parallel.pipeline import stage_devices

        # a ring of --hops stages, all on --device (as --stages places them)
        ring = stage_devices(args.hops, [device] * args.hops)
        hop = measure_hop_latency(ring, hidden_size=cfg.hidden_size, dtype=dtype)

    extra = {"config": json.loads(cfg.to_json())}
    # the memory fit only where device memory is known: --hbm-gib, or the
    # card's; on the CPU the field is left out rather than guessed
    hbm = int(args.hbm_gib * 1024**3) if args.hbm_gib else detect_hbm_bytes(device)
    if hbm is not None:
        extra["max_layers_fit"] = max_layers_fit(cfg, param_dtype=dtype, hbm_bytes=hbm)
    if args.suggest_stages:
        from .parallel.placement import PlacementSpec

        # homogeneous devices: each stage's capability is 1 / c_k
        spec = PlacementSpec.from_capabilities(
            cfg.num_hidden_layers, [1.0 / prefill.capability_c_k] * args.suggest_stages
        )
        extra["suggested_placement"] = list(spec.stages)

    payload = save_profile_artifacts(
        args.out, prefill=prefill, decode=decode, verdict=verdict,
        cold_start=cold, hop=hop, extra=extra,
    )
    print(json.dumps(payload, indent=2))
    print(f"artifacts -> {args.out}", file=sys.stderr)
    return 0


def cmd_lint(args) -> int:
    """shardlint over the port (``analysis/``; JAX ``cli.py:1435``): exits
    nonzero on findings not in the baseline. Needs no torch."""
    from .analysis.core import run_lint

    return run_lint(
        only=args.rule or None,
        baseline_path=args.baseline,
        as_json=args.json,
        write_baseline=args.write_baseline,
    )


def _add_device(p) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the plain PyTorch "
        "path, as the tests do). Without a GPU the default raises",
    )


def _add_generate(sub) -> None:
    g = sub.add_parser("generate", help="run one prompt")
    g.add_argument("shards")
    _add_prompt(g)
    g.add_argument("--max-new", type=int, default=128, dest="max_new")
    g.add_argument("--stages", type=int)
    g.add_argument("--ranges", help="ragged layer ranges (ROADMAP.md §A 15)")
    g.add_argument("--tensor-parallel", type=int, default=1, dest="tensor_parallel",
                   help="megatron tensor parallelism per stage (devices = stages x tp, "
                   "all on --device)")
    g.add_argument("--dtype", default="bf16")
    g.add_argument("--stream", action="store_true")
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0, dest="top_k")
    g.add_argument("--top-p", type=float, default=1.0, dest="top_p")
    g.add_argument("--seed", type=int, default=0)
    _add_device(g)
    g.set_defaults(fn=cmd_generate)


def _add_prompt(p) -> None:
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--prompt")
    g.add_argument("--prompt-ids", dest="prompt_ids",
                   help="comma-separated token ids instead of --prompt (a store without a "
                   "tokenizer); the generated ids are printed")


def _add_serve(sub) -> None:
    """The JAX ``serve`` parser (``cli.py:1494-1814``): the same names and
    defaults; the flags of later slices are parsed and refused."""
    s = sub.add_parser("serve", help="persistent stdin daemon (streaming), HTTP ingress")
    s.add_argument("shards")
    s.add_argument("--max-new", type=int, default=256, dest="max_new")
    s.add_argument("--capacity", type=int, default=1024)
    s.add_argument("--batch-per-slot", type=int, default=1, dest="batch_per_slot",
                   help="rows served at once")
    s.add_argument("--prefill-chunk", type=int, default=None, dest="prefill_chunk",
                   help="prefill prompts longer than this in chunks (power of two)")
    s.add_argument("--speculate", type=int, default=0,
                   help="verify up to K n-gram drafts per row per step (0 = off)")
    s.add_argument("--spec-ngram", type=int, default=3, dest="spec_ngram")
    s.add_argument("--inflight-steps", type=int, default=1, dest="inflight_steps",
                   help="decode dispatches the async executor keeps in flight (1: serial)")
    s.add_argument("--dtype", default="bf16")
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--seed", type=int, default=0,
                   help="base sampling seed; each submitted prompt advances it by one")
    s.add_argument("--top-k", type=int, default=0, dest="top_k")
    s.add_argument("--top-p", type=float, default=1.0, dest="top_p")
    s.add_argument("--stop", action="append", default=None,
                   help="stop string (repeatable; needs a tokenizer)")
    s.add_argument("--max-queue", type=int, default=0, dest="max_queue",
                   help="reject submits once this many wait (0 = unbounded)")
    s.add_argument("--default-deadline", type=float, default=0.0, dest="default_deadline",
                   help="default per-request deadline in seconds (0 = none)")
    s.add_argument("--kv-block-size", type=int, default=0, dest="kv_block_size",
                   help="paged KV: tokens per arena block (0 = dense, the default)")
    s.add_argument("--kv-blocks", type=int, default=0, dest="kv_blocks",
                   help="paged KV: arena blocks (>= 2; block 0 is the trash sink)")
    s.add_argument("--kv-dtype", choices=("bf16", "int8", "fp8"), default="bf16",
                   dest="kv_dtype", help="paged arena storage")
    s.add_argument("--paged-attn", choices=("auto", "kernel", "plain", "xla"), default="auto",
                   dest="paged_attn",
                   help="paged attention path: the CUDA kernels, or plain (xla: the JAX "
                   "name of the plain path)")
    s.add_argument("--prefix-cache", choices=("off", "hbm", "host", "disk"), default="off",
                   dest="prefix_cache", help="automatic prefix cache (paged only)")
    s.add_argument("--host-pool-blocks", type=int, default=0, dest="host_pool_blocks")
    s.add_argument("--disk-pool-dir", default=None, dest="disk_pool_dir")
    s.add_argument("--disk-pool-blocks", type=int, default=0, dest="disk_pool_blocks")
    s.add_argument("--snapshot-every", type=float, default=0.0, dest="snapshot_every",
                   help="auto-checkpoint at most every N seconds into --snapshot-dir")
    s.add_argument("--snapshot-dir", default=None, dest="snapshot_dir")
    s.add_argument("--restore", default=None, help="resume a ':snapshot DIR' checkpoint")
    s.add_argument("--metrics-port", type=int, default=0, dest="metrics_port",
                   help="/metrics, /statz, /profilez, /healthz on 127.0.0.1:PORT (0 = off)")
    s.add_argument("--http-port", type=int, default=0, dest="http_port",
                   help="the HTTP/SSE ingress on 127.0.0.1:PORT: POST /v1/completions and "
                   "/v1/embeddings, tenant fairness, typed 429/503/504 (0 = off)")
    s.add_argument("--tenants-config", default=None, dest="tenants_config",
                   help="JSON tenant policy for --http-port: {\"tenants\": {NAME: {\"key\": "
                   "BEARER, \"weight\": W, \"rate_rps\": R, \"burst\": B, \"max_queued\": "
                   "Q}}, \"allow_anonymous\": bool}")
    s.add_argument("--drain-grace", type=float, default=60.0, dest="drain_grace",
                   help="seconds a SIGTERM drain waits for live HTTP streams")
    s.add_argument("--trace-path", default=None, dest="trace_path",
                   help="JSONL span file (PATH.ingress gets the HTTP root spans)")
    s.add_argument("--gauge-sweep-every", type=float, default=0.0, dest="gauge_sweep_every",
                   help="pace the per-step load-gauge sweep (seconds; 0 = every step)")
    # the fleet (runtime/replicated.py, disagg.py, autoscale.py)
    s.add_argument("--data-parallel", type=int, default=1, dest="data_parallel",
                   help="serve N replicas behind the supervised least-loaded router, all on "
                   "--device (one GPU serves them all)")
    s.add_argument("--min-replicas", type=int, default=1, dest="min_replicas",
                   help="with --data-parallel: refuse ':drain N' below this many live replicas")
    s.add_argument("--autoscale", action="store_true",
                   help="with --data-parallel: drain/spawn replicas from the load signal "
                   "(queued + in-flight + ingress backlog over live slots) with hysteresis")
    for flag, dest, default, what in (
        ("--autoscale-up-load", "autoscale_up_load", 0.8, "spawn at load >= this, sustained"),
        ("--autoscale-down-load", "autoscale_down_load", 0.3, "drain at load <= this, sustained"),
        ("--autoscale-up-after", "autoscale_up_after", 1.0, "seconds high load must sustain"),
        ("--autoscale-down-after", "autoscale_down_after", 5.0, "seconds low load must sustain"),
        ("--autoscale-cooldown", "autoscale_cooldown", 3.0,
         "seconds after a scale action that only observe"),
        ("--rebalance-every", "rebalance_every", 30.0,
         "with --autoscale --disagg --profile-json: seconds between role-rebalance attempts "
         "(0 = off)"),
    ):
        s.add_argument(flag, dest=dest, type=float, default=default,
                       help=f"{what} (default {default:g})")
    s.add_argument("--disagg", action="store_true",
                   help="prefill/decode roles (with --data-parallel >= 2, --kv-block-size/"
                   "--kv-blocks and --prefix-cache): prefill replicas hand each request's KV "
                   "blocks to a decode replica after its first token; default 1 prefill, rest "
                   "decode")
    s.add_argument("--prefill-replicas", type=int, default=0, dest="prefill_replicas",
                   help="with --disagg: the first N replicas prefill, the rest decode")
    s.add_argument("--roles", default=None,
                   help="with --disagg: comma-separated prefill/decode/unified per replica")
    s.add_argument("--profile-json", default=None, dest="profile_json",
                   help="with --disagg: a profile.json (or its directory) of fitted "
                   "prefill/decode latency models for the placement planner")
    s.add_argument("--stages", type=int)
    s.add_argument("--ranges")
    s.add_argument("--tensor-parallel", type=int, default=1, dest="tensor_parallel",
                   help="megatron tensor parallelism per pipeline (composes with --stages and "
                   "--data-parallel: devices = dp x stages x tp, all on --device)")
    s.add_argument("--cp", dest="cp", type=int, default=1,
                   help="context-parallel serving: split the paged arena over N shards "
                   "(--kv-blocks per shard; devices = cp x stages, all on --device), so a "
                   "context cp times one shard's arena admits; greedy output is cp=1's")
    _add_device(s)
    s.set_defaults(fn=cmd_serve)


def _add_ring(sub) -> None:
    """``worker`` and ``launch`` (JAX ``cli.py:1817-1860``): the same flags,
    plus ``--device`` and ``--prompt-ids``. ``--platform`` defaults to
    ``inherit`` (the card, through ``--device``): JAX's default ``cpu``
    would run a port entry point on the CPU unasked."""
    w = sub.add_parser("worker", help="one process of the multi-process ring (one per stage)")
    w.add_argument("shards")
    w.add_argument("--coordinator", required=True, help="host:port of rank 0's rendezvous")
    w.add_argument("--processes", type=int, required=True)
    w.add_argument("--process-id", type=int, required=True, dest="process_id")
    _add_prompt(w)
    w.add_argument("--max-new", type=int, default=64, dest="max_new")
    w.add_argument("--ranges", help="each rank's layers, a:b,... (default balanced)")
    w.add_argument("--dtype", default="bf16")
    w.add_argument("--metrics-port", type=int, default=0, dest="metrics_port",
                   help="expose /metrics on 127.0.0.1:(PORT + process-id) (0 = off)")
    w.add_argument("--cp", type=int, default=1, help="refused above 1: one process's server only")
    _add_device(w)
    w.set_defaults(fn=cmd_worker)

    la = sub.add_parser("launch", help="spawn N workers on this host")
    la.add_argument("shards")
    la.add_argument("--processes", type=int, default=2)
    _add_prompt(la)
    la.add_argument("--max-new", type=int, default=64, dest="max_new")
    la.add_argument("--ranges")
    la.add_argument("--dtype", default="bf16")
    la.add_argument("--platform", default="inherit", choices=["cpu", "inherit"],
                    help="inherit: every rank on --device (default); cpu: on the CPU")
    la.add_argument("--log-dir", default="results/launch", dest="log_dir")
    la.add_argument("--timeout", type=float, default=900.0,
                    help="kill all workers after this many seconds (0 = no limit)")
    la.add_argument("--metrics-port", type=int, default=0, dest="metrics_port",
                    help="base port for per-worker /metrics: worker i binds PORT+i (0 = off)")
    _add_device(la)
    la.set_defaults(fn=cmd_launch)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m llm_sharding_tpu_torch",
        description="PyTorch/CUDA port of llm_sharding_tpu: operator commands",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)
    _add_generate(sub)
    _add_serve(sub)
    _add_ring(sub)
    c = sub.add_parser("convert", help="HF checkpoint dir -> shard store")
    c.add_argument("model_dir")
    c.add_argument("out_dir")
    c.add_argument("--dtype", default="bf16")
    c.add_argument(
        "--quantize-head", action="store_true", dest="quantize_head",
        help="with --dtype int8/int4: also quantize the vocab tables (embed "
        "per-row scales, untied lm_head per-column)",
    )
    c.set_defaults(fn=cmd_convert)

    tr = sub.add_parser(
        "trace-report",
        help="merge JSONL trace files, rebuild span trees, attribute "
        "latency per phase/tenant",
    )
    tr.add_argument(
        "files", nargs="+",
        help="trace files (globs ok): PATH, PATH.r<i>, PATH.router, "
        "PATH.ingress, PATH*.1 rollovers — any subset; spans join by "
        "trace_id",
    )
    tr.add_argument("--top", type=int, default=5,
                    help="how many slowest traces to list (default 5)")
    tr.add_argument("--trace", default=None,
                    help="print one trace's full span tree instead of the summary")
    tr.add_argument("--json", action="store_true",
                    help="machine-readable report (one JSON object)")
    tr.set_defaults(fn=cmd_trace_report)

    sr = sub.add_parser(
        "step-report",
        help="render step-profiler captures (/profilez bundles, /debugz "
        "postmortems, :profile dumps): per-phase host-time attribution, "
        "occupancy timeline, worst device bubbles",
    )
    sr.add_argument(
        "files", nargs="+",
        help="capture JSON files (globs ok): /profilez?steps=N bundles, "
        "/debugz bundles (the recent_steps ring tails), or :profile "
        "output — any mix; records merge sorted by timestamp",
    )
    sr.add_argument("--top", type=int, default=5,
                    help="how many worst device-idle bubbles to list (default 5)")
    sr.add_argument("--json", action="store_true",
                    help="machine-readable report (one JSON object)")
    sr.set_defaults(fn=cmd_step_report)
    _add_profile(sub)
    _add_lint(sub)
    return p


def _add_profile(sub) -> None:
    """The JAX ``profile`` parser (``cli.py:1870-1894``), plus ``--device``."""
    pr = sub.add_parser("profile", help="capability sweeps + artifacts")
    src = pr.add_mutually_exclusive_group(required=True)
    src.add_argument("--shards")
    src.add_argument(
        "--preset",
        help="config preset name (random weights), e.g. tiny_llama, llama32_3b",
    )
    pr.add_argument("--out", default="results/profiling")
    pr.add_argument("--dtype", default="bf16")
    pr.add_argument("--decode-tokens", type=int, default=64, dest="decode_tokens")
    pr.add_argument(
        "--hops", type=int, default=0,
        help="measure the per-hop latency of a decode-shaped block around a ring of N "
        "stages, all on --device",
    )
    pr.add_argument("--cold-start", action="store_true", dest="cold_start")
    pr.add_argument(
        "--hbm-gib", type=float, default=0.0, dest="hbm_gib",
        help="device memory to assume for max_layers_fit (read from the card by "
        "default; omitted from the report on the CPU)",
    )
    pr.add_argument(
        "--suggest-stages", type=int, default=0, dest="suggest_stages",
        help="emit a capability-weighted placement for N stages",
    )
    _add_device(pr)
    pr.set_defaults(fn=cmd_profile)


def _add_lint(sub) -> None:
    """The JAX ``lint`` parser (``cli.py:1946-1975``), over the port."""
    li = sub.add_parser(
        "lint",
        help="shardlint over the port: lock order, metrics/trace discipline; "
        "exits nonzero on new findings",
    )
    li.add_argument(
        "--rule", action="append", default=None, metavar="RULE",
        help="run only this rule (repeatable): lock-order, metrics-discipline, "
        "trace-discipline (dispatch-statics and donation-safety are jit rules, "
        "not ported)",
    )
    li.add_argument("--json", action="store_true",
                    help="machine-readable report (one JSON object)")
    li.add_argument(
        "--baseline", default=None,
        help="baseline file of known finding fingerprints (default: "
        "llm_sharding_tpu_torch/analysis/baseline.json, committed empty)",
    )
    li.add_argument(
        "--write-baseline", action="store_true",
        help="regenerate the baseline from the current findings instead of "
        "failing on them (the intended state is an empty baseline)",
    )
    li.set_defaults(fn=cmd_lint)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return args.fn(args)
