"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or the JAX package ``repro``.

Two checks.  Every module imports in a fresh interpreter in which an import
hook refuses ``jax``, ``jaxlib`` and ``repro``/``repro.*`` (but not
``repro_torch``, which shares the prefix).  And an AST scan of the sources
finds no such import statement, including ones inside functions that the
import check would not run.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _modules() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        parts = list(path.relative_to(PORT.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


_BLOCKED_IMPORT = """
import importlib.abc, importlib.util, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {src!r})
for name in {modules!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r})
assert not leaked, leaked
print("ok", len({modules!r}))
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = _modules()
    assert "repro_torch.kernels.ops" in modules
    code = _BLOCKED_IMPORT.format(blocked=set(FORBIDDEN), src=str(REPO / "src"),
                                  modules=modules,
                                  smoke=str(REPO / "chip_smoke.py"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", str(len(modules))]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_prefix_check_tells_repro_from_repro_torch():
    assert _forbidden("repro") and _forbidden("repro.models.attention")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.kernels")
