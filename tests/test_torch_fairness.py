"""The port's ``runtime/fairness.py`` against the JAX package's: the same
operation sequence under one fake clock gives the same ``FairQueue`` pops,
``TokenBucket`` grants, ``retry_after`` values (exactly equal floats: both
compute the same expressions) and the same ``load_tenants_config``
results and refusals in both packages. The module imports no JAX.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from llm_sharding_tpu.runtime import fairness as jf
from llm_sharding_tpu_torch.runtime import fairness as tf

CONFIG = {
    "tenants": {
        "alice": {"key": "sk-a", "weight": 2.0, "rate_rps": 4, "burst": 3, "max_queued": 5},
        "bob": {"key": "sk-b", "rate_rps": 2},
        "carol": {"weight": 0.5, "max_queued": 2},
    },
    "allow_anonymous": True,
}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _outcome(fn):
    """A call's result or its exception's type, message and retry hint."""
    try:
        return ("ok", fn())
    except (jf.RateLimited, tf.RateLimited, jf.TenantQueueFull, tf.TenantQueueFull) as e:
        return (type(e).__name__, str(e), e.retry_after_s)
    except Exception as e:  # noqa: BLE001 — compared by type name and message
        return (type(e).__name__, str(e))


def _drive(mod, seed: int) -> list:
    """A seeded random sequence of admissions, pops, charges, sweeps and
    clock advances; every observable outcome, in order."""
    clock = Clock()
    cfgs, anon = mod.load_tenants_config(CONFIG)
    fq = mod.FairQueue(cfgs, allow_anonymous=anon, clock=clock)
    rng = np.random.default_rng(seed)
    names = ["alice", "bob", "carol", "default"]
    seen, n = [], 0
    for _ in range(160):
        op = rng.integers(0, 7)
        name = names[rng.integers(0, 4)]
        if op <= 2:
            n += 1
            seen.append(("admit", name, _outcome(
                lambda: fq.admit_and_push(name, n, total_cap=9))))
        elif op == 3:
            seen.append(("pop", fq.pop()))
        elif op == 4:
            tokens = int(rng.integers(1, 40))
            fq.charge(name, tokens, kind="decode" if rng.integers(0, 2) else "prefill")
            seen.append(("service", name, fq.service_of(name)))
        elif op == 5:
            clock.t += float(rng.integers(0, 1000)) / 997.0
        else:
            cut = int(rng.integers(0, n + 1))
            seen.append(("sweep", fq.sweep(lambda item, cut=cut: item < cut)))
        seen.append(("depth", fq.depth(), tuple(fq.depth(x) for x in names)))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fair_queue_sequence_matches_jax(seed):
    assert _drive(tf, seed) == _drive(jf, seed)


def test_token_bucket_grants_and_retry_after_match_jax():
    out = []
    for mod in (jf, tf):
        clock = Clock()
        b = mod.TokenBucket(3.0, 2.5, clock=clock)
        seen = []
        for i in range(40):
            n = 0.5 + (i % 3)
            seen.append((b.try_acquire(n), b.retry_after(n)))
            clock.t += (i % 5) * 0.137
        out.append(seen)
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="rate must be > 0"):
        tf.TokenBucket(0.0, 1.0)


def test_resolve_matches_jax():
    cases = [dict(bearer="sk-a"), dict(bearer="sk-x"), dict(header="carol"),
             dict(header="alice"), dict(header="nobody"), dict()]
    for anon in (True, False):
        got = []
        for mod in (jf, tf):
            cfgs, _ = mod.load_tenants_config(CONFIG)
            fq = mod.FairQueue(cfgs, allow_anonymous=anon)
            got.append([_outcome(lambda kw=kw: fq.resolve(**kw)) for kw in cases]
                       + [fq.tenants()])
        assert got[0] == got[1]


@pytest.mark.parametrize("source", [
    json.dumps(CONFIG),
    {"tenants": {"a": {"key": "k"}, "b": {"key": "k"}}},
    {"tenants": {"a": {"weight": 0}}},
    {"tenants": {"a": {"burst": 3}}},
    {"tenants": {"a": {"max_queued": 0}}},
    {"tenants": {"a": {"key": "k"}}},
    [1, 2],
], ids=["full", "shared-key", "weight", "burst-alone", "max-queued", "keyed-no-anon", "list"])
def test_load_tenants_config_matches_jax(source):
    def load(mod):
        r = _outcome(lambda: mod.load_tenants_config(source))
        if r[0] == "ok":
            cfgs, anon = r[1]
            return [tuple(sorted(vars(c).items())) for c in cfgs], anon
        return r

    assert load(tf) == load(jf)


def test_load_tenants_config_from_a_file(tmp_path):
    p = tmp_path / "tenants.json"
    p.write_text(json.dumps(CONFIG))
    cfgs, anon = tf.load_tenants_config(str(p))
    assert [c.name for c in cfgs] == ["alice", "bob", "carol"] and anon


def test_new_modules_import_no_jax():
    """The slice's modules and the CLI load with ``jax`` and the JAX
    package unimportable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'jaxlib')) or name == "
        "'llm_sharding_tpu' or name.startswith('llm_sharding_tpu.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import llm_sharding_tpu_torch.runtime.fairness\n"
        "import llm_sharding_tpu_torch.runtime.ingress\n"
        "import llm_sharding_tpu_torch.runtime.server\n"
        "import llm_sharding_tpu_torch.runtime.engine\n"
        "import llm_sharding_tpu_torch.runtime.generate\n"
        "import llm_sharding_tpu_torch.parallel.serve\n"
        "import llm_sharding_tpu_torch.cli\n"
        "assert not any(m == 'jax' or m.startswith('llm_sharding_tpu.') for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
