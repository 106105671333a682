"""No module the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the reference imports none of ``jax``, ``repro`` or ``repro_torch``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchlib import cli

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


def test_no_source_under_bench_names_jax_or_repro():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    names = _imports(BENCH / "benchlib" / "reference.py")
    assert not names & (FORBIDDEN | {"repro_torch"})
    for dep in ("traffic", "weights"):
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


def test_the_check_compares_top_level_names_whole():
    assert cli.forbidden_modules(["repro_torch", "repro_torch.launch",
                                  "reprox", "jaxtyping"]) == []
    assert cli.forbidden_modules(["repro.models", "numpy"]) == ["repro"]
    assert cli.forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]
