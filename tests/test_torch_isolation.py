"""The PyTorch port imports neither JAX (nor optax, orbax) nor the JAX
package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "iadmm_tpu")
PORT_FILES = sorted((ROOT / "iadmm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import iadmm_tpu_torch, iadmm_tpu_torch.api, "
        "iadmm_tpu_torch.convert, iadmm_tpu_torch.kernels.rollout_kernel, "
        "iadmm_tpu_torch.config, iadmm_tpu_torch.train.harness, "
        "iadmm_tpu_torch.kernels.train_rollout, iadmm_tpu_torch.cli.train\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
