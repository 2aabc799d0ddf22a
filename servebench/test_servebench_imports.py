"""Nothing the chip run imports is JAX or the JAX package (top-level names
compared whole: ``llm_sharding_tpu_torch`` is the port), and the reference
imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from servebench.run import FORBIDDEN, forbidden_modules

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def imports(path: Path) -> set:
    """``(level, top-level name)`` of every import in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {(0, a.name.split(".")[0]) for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add((node.level, (node.module or "").split(".")[0]))
    return out


SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    names = {name for level, name in imports(path) if level == 0}
    assert not names & set(FORBIDDEN), f"{path} imports {names & set(FORBIDDEN)}"


def test_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").glob("*.py"):
        for level, name in imports(path):
            assert name not in ("llm_sharding_tpu_torch", "llm_sharding_tpu"), path
            if level == 2:  # servebench itself: only the seeded weights
                assert name in ("", "weights"), path
            assert level in (0, 1, 2) and (level != 1 or name in ("", "qwen2")), path
        src = path.read_text()
        assert "from .. import weights" in src or "weights" not in src


def test_forbidden_names_compare_whole():
    keep = dict(sys.modules)
    try:
        sys.modules["llm_sharding_tpu_torch_fake"] = sys
        sys.modules["jaxfake.x"] = sys
        assert forbidden_modules() == []
        sys.modules["llm_sharding_tpu.models"] = sys
        assert forbidden_modules() == ["llm_sharding_tpu.models"]
    finally:
        sys.modules.clear()
        sys.modules.update(keep)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from conftest import TINY_MIXES, run_tiny\n"
        "res, lines, items = run_tiny(TINY_MIXES['closed'], seconds=0.5)\n"
        "from servebench.run import forbidden_modules\n"
        "assert 'llm_sharding_tpu_torch' in sys.modules\n"
        "print('FORBIDDEN', forbidden_modules())\n"
    ) % (str(ROOT), str(PKG))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
