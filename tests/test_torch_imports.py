"""The port stands alone: every module of ``osufusion_tpu_torch`` imports in an
interpreter where ``jax``, ``flax``, ``optax``, ``orbax`` and ``osufusion_tpu``
cannot be imported, and its scripts name none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "osufusion_tpu")

WALK = f"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = {FORBIDDEN!r}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"the port must not import {{name}}")
        return None


sys.meta_path.insert(0, Refuse())
import osufusion_tpu_torch

names = ["osufusion_tpu_torch"] + [m.name for m in pkgutil.walk_packages(osufusion_tpu_torch.__path__, "osufusion_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in FORBIDDEN], "a forbidden module was imported"
print(len(names))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", WALK], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # osu (6) + codec (6) + train (3) + trainer and the serving modules
    assert int(proc.stdout.strip().splitlines()[-1]) >= 40


def test_the_refusal_is_real():
    """The same interpreter set-up refuses the JAX package itself."""
    probe = WALK.split("import osufusion_tpu_torch")[0] + "import osufusion_tpu.codec.decode\n"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "must not import" in proc.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_torch_serve.py", "tests/test_torch_kernels.py"])
def test_scripts_import_nothing_of_jax(script):
    roots = _imported_roots(ROOT / script)
    assert "torch" in roots and not roots & set(FORBIDDEN)


def test_package_sources_name_no_forbidden_import():
    """Function-level imports too, which the import walk would not run."""
    for path in sorted((ROOT / "osufusion_tpu_torch").rglob("*.py")):
        assert not _imported_roots(path) & set(FORBIDDEN), path
