"""No module the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
no architecture module that a configuration names (``spec.architecture``,
the committed ones' and the tests'), nor what it is built on, imports
``repro_torch``, but for ``repro_torch.configs`` inside ``port_config``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from bench_tiny import HYBRID, MOE, SSM

from benchlib import cli, spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _scoped_imports(path: Path) -> list[tuple[str | None, str]]:
    """(the enclosing function's name or None, the module's dotted name) of
    every absolute import in ``path``."""
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                out.extend((fn, a.name) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((fn, child.module))
            visit(child, child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)

    visit(ast.parse(path.read_text()), None)
    return out


def _configs() -> list[dict]:
    """Every configuration: the committed ones and the tests'."""
    return [spec.config(c["name"]) for c in spec.benchmark()["configs"]] + [
        MOE, SSM, HYBRID]


def _architecture_modules() -> list[Path]:
    return sorted({(ROOT / c["reference"]).resolve() for c in _configs()})


def test_no_source_under_bench_names_jax_or_repro():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    modules = _architecture_modules()
    assert BENCH / "benchlib" / "reference.py" in modules
    assert BENCH / "tests" / "tiny_hybrid.py" in modules
    for path in modules:
        assert not _imports(path) & FORBIDDEN, path
        for fn, name in _scoped_imports(path):
            if name.split(".")[0] == "repro_torch":
                assert fn == "port_config", (path, fn, name)
                assert name.startswith("repro_torch.configs"), (path, name)
    for dep in ("traffic", "weights", "counts"):
        assert not _imports(BENCH / "benchlib" / f"{dep}.py") & (
            FORBIDDEN | {"repro_torch"})


def _loaded_after(code: str) -> list[str]:
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, "
            f"{str(ROOT / 'src')!r}]\n{code}\nimport json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_what_a_run_loads_holds_no_jax_and_no_repro():
    metrics = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))
    loaded = _loaded_after(
        "import benchlib.cli, benchlib.drivers.train, "
        "benchlib.drivers.serve_grouped\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "from benchlib import spec\n"
        f"for m in {metrics!r}: spec.reader(m)")
    assert "repro_torch" in loaded
    assert not set(loaded) & FORBIDDEN
    assert cli.forbidden_modules(loaded) == []


def test_the_reference_loads_no_program():
    loaded = _loaded_after("import benchlib.reference")
    assert not set(loaded) & (FORBIDDEN | {"repro_torch"})
    loaded = _loaded_after(
        "from benchlib import spec\n"
        f"for cfg in {_configs()!r}: spec.architecture(cfg)")
    assert not set(loaded) & (FORBIDDEN | {"repro_torch"})
    loaded = _loaded_after(
        "from benchlib import spec\n"
        f"for cfg in {_configs()!r}: spec.architecture(cfg).port_config(cfg)")
    assert "repro_torch" in loaded and not set(loaded) & FORBIDDEN


def test_the_check_compares_top_level_names_whole():
    assert cli.forbidden_modules(["repro_torch", "repro_torch.launch",
                                  "reprox", "jaxtyping"]) == []
    assert cli.forbidden_modules(["repro.models", "numpy"]) == ["repro"]
    assert cli.forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]
