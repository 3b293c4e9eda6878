"""The import guard, and a reference that imports nothing of JAX, the JAX
package or the port."""

import ast
import os
import subprocess
import sys

from portbench import harness

REFERENCE = os.path.join(harness.HERE, "reference")


def test_guard_compares_whole_top_level_names():
    mods = ["ps_slm_tpu_torch", "ps_slm_tpu_torch.models", "torch", "jaxtyping", "flaxen"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy", "ps_slm_tpu.ops", "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "ps_slm_tpu.ops"]


def test_reference_sources_import_nothing_forbidden():
    for name in sorted(os.listdir(REFERENCE)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REFERENCE, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            for top in tops:
                assert top not in ("jax", "jaxlib", "flax", "ps_slm_tpu", "ps_slm_tpu_torch"), \
                    f"{name} imports {top}"


def test_reference_loads_alone():
    code = ("import sys, portbench.reference.tasu, portbench.reference.llm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ps_slm_tpu', 'ps_slm_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(harness.HERE)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
