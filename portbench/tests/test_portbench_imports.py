"""What the benchmark loads: no JAX, no JAX library and not the JAX
package, by the top-level module name compared whole; and a reference that
imports nothing of the port."""

import ast
import subprocess
import sys
import textwrap

from portbench.harness import env

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_eeg_fmri_tpu"}
PORT = "multimodal_eeg_fmri_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_top_level_names_are_compared_whole():
    assert env.top_level([PORT + ".ops", "jax.numpy"]) == {PORT, "jax"}
    assert env.forbidden_loaded({PORT: 1, PORT + ".models": 1}) == []
    assert env.forbidden_loaded({"multimodal_eeg_fmri_tpu.models": 1}) == [
        "multimodal_eeg_fmri_tpu"]


def test_no_source_of_the_benchmark_imports_jax():
    for path in env.BENCH.rglob("*.py"):
        names = env.top_level(_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in (env.BENCH / "reference").glob("*.py"):
        names = env.top_level(_imports(path))
        assert PORT not in names and not names & FORBIDDEN, path
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(env.ROOT)!r})
        from portbench.harness import registry
        for name in ("lc-moe", "mm-e2e"):
            registry.reference(name)
        print(sorted(n for n in sys.modules
                     if n.split(".")[0] in {sorted(FORBIDDEN | {PORT})!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=env.ROOT)
    assert out.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax():
    """Every cell run at small sizes in one fresh process, then its
    modules looked at, as run.py does once the window has closed."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(env.ROOT)!r})
        import torch
        torch.set_num_threads(2)
        from portbench.tests.small import run_small, SMALL
        from portbench.harness import env
        for name in SMALL:
            for trace in (False, True):
                assert run_small(name, trace=trace)["correct"], name
        print(env.forbidden_loaded())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=env.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
