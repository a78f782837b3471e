"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference reaches nothing of the port.

The walk follows every import statement (top level or inside a function) of
the benchmark's modules into the repository's own packages, the port's
included, and collects the top-level name of each module it meets; names
are compared whole, since the port's name begins with the JAX package's.
"""
import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
OWN = ("benchmark", "optix_raytracer_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optix_raytracer_tpu"}


def _module_file(name):
    """The source file of one of the repository's own modules; None for
    other packages and for names that are members, not modules."""
    if name.split(".", 1)[0] not in OWN:
        return None
    try:
        spec = importlib.util.find_spec(name)
    except (ImportError, ValueError, AttributeError):
        return None
    return Path(spec.origin) if spec and spec.origin else None


def _imports(path: Path, package: str):
    """Fully qualified names of the modules a file imports (both a package
    and its named members, for `from x import y`)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.rsplit(".", node.level - 1)[0] \
                    if node.level > 1 else package
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.append(mod)
            out += [f"{mod}.{a.name}" for a in node.names]
    return out


def _package_of(path: Path) -> str:
    rel = path.resolve().relative_to(ROOT).with_suffix("")
    return ".".join(rel.parts[:-1])


def walk(roots):
    """→ (top-level names met, own modules met) from the root files."""
    seen_files, tops, modules = set(), set(), set()
    todo = [Path(r).resolve() for r in roots]
    while todo:
        f = todo.pop()
        if f in seen_files:
            continue
        seen_files.add(f)
        for name in _imports(f, _package_of(f)):
            tops.add(name.split(".", 1)[0])
            target = _module_file(name)
            if target is not None and target.suffix == ".py":
                modules.add(name)
                todo.append(target)
    return tops, modules


def benchmark_files():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


def test_nothing_the_benchmark_runs_imports_jax():
    tops, modules = walk(benchmark_files())
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)
    # the walk did go into the port
    assert any(m.startswith("optix_raytracer_tpu_torch.wavefront")
               for m in modules)


def test_the_reference_reaches_nothing_of_the_port():
    tops, _ = walk(sorted((BENCH / "reference").glob("*.py"))
                   + [BENCH / "control.py", BENCH / "check.py"])
    assert "optix_raytracer_tpu_torch" not in tops
    assert not tops & FORBIDDEN


def test_top_level_names_are_compared_whole():
    tops, _ = walk([BENCH / "harness.py"])
    assert "optix_raytracer_tpu_torch" in tops
    assert "optix_raytracer_tpu" not in tops


def test_no_file_names_the_jax_benchmark():
    words = ("bench" + ".py", "BENCH" + "_", "RMSE" + ".json",
             "MULTICHIP" + "_")
    for p in sorted(BENCH.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts \
                and ".cache" not in p.parts:
            text = p.read_text(errors="replace")
            for w in words:
                assert w not in text, f"{p} names {w}"
    text = (ROOT / "BENCHMARK.json").read_text()
    assert not any(w in text for w in words)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run (on the CPU, at tiny sizes) in a process of its own, then
    the modules it holds."""
    from .conftest import make_tiny_root
    root = make_tiny_root(tmp_path / "checkout", pixels=16)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        f"rc, res = harness.run({str(root)!r}, 'cornell-interactive', 3, 0.2,"
        " False, device='cpu')\n"
        "print(json.dumps([rc, res is not None,"
        " sorted({m.split('.')[0] for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    rc, printed, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and printed
    assert "optix_raytracer_tpu_torch" in tops
    assert not set(tops) & FORBIDDEN
