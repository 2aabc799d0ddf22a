"""shardlint over the port (``python -m llm_sharding_tpu_torch lint``):
the port of ``llm_sharding_tpu/analysis/``. :func:`core.run_lint` drives
three AST rules over the package source, with no torch import:

- ``lock-order``         — the static lock-acquisition graph respects the
  canonical hierarchy in :mod:`.lockorder` (no cycles, no unregistered
  locks);
- ``metrics-discipline`` — registrations have help text + README rows (and
  vice versa), label sets consistent at feed sites;
- ``trace-discipline``   — emitted span names match the README span-schema
  table (and vice versa).

The JAX package's ``dispatch-statics`` and ``donation-safety`` rules are
specific to jit and are not ported. This ``__init__`` imports nothing: the
runtime modules import :mod:`.lockorder` (``named_lock``) when they build
their locks.
"""
