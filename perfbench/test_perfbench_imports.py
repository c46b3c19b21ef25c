"""Nothing the benchmark runs imports JAX or the JAX package, judged by
each module's whole top-level name (the part before the first dot:
``repro_torch`` is the port and passes, ``repro`` is the JAX package and
does not); the plain reference imports nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _bench_files():
    return sorted(p for p in HERE.rglob("*.py")
                  if not p.name.startswith("test_")
                  and "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _bench_files(),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import_in_benchmark_sources(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"torch", "math", "typing", "__future__"}, tops
    text = path.read_text()
    for name in ("repro_torch", "ssd_chunked", "_attention_core",
                 "kernels.ref"):
        assert name not in text.replace("``" + name, ""), name


def test_whole_name_rule():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


def test_modules_a_run_loads():
    """Import everything a run imports -- run.py's harness, each kind,
    metric reader and reference, and the program's entry points they
    reach -- in a fresh process, and list the top-level modules loaded."""
    code = f"""
import sys, runpy
sys.argv = ["run.py"]
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(HERE)!r}]
from pathlib import Path
from harness import core, runner, smoke
for kind in Path({str(HERE / 'kinds')!r}).glob("*.py"):
    core.load_module(kind)
for m in Path({str(HERE / 'metrics')!r}).glob("*.py"):
    core.load_module(m)
import reference.mamba2, reference.olmo
import repro_torch.serve.step, repro_torch.train.step
import repro_torch.train.schedule, repro_torch.models.model
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "repro_torch" in tops


def test_reference_alone_loads_no_program():
    code = f"""
import sys
sys.path[:0] = [{str(HERE)!r}]
import reference.mamba2, reference.olmo, reference.precision
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"repro_torch", "harness"})
