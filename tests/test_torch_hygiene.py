"""The port stands alone: no file of ``repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package, and the port imports with both blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_reference(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.rollout, repro_torch.core.bridge\n"
            "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
            "import repro_torch.models, repro_torch.models.ssm\n"
            "import repro_torch.configs, repro_torch.kernels.ssm_scan\n"
            "import repro_torch.train.steps, repro_torch.train.checkpoint\n"
            "import repro_torch.optim, repro_torch.core.devreplay\n"
            "import repro_torch.nn.pytree, repro_torch.train._msgpack\n"
            "import repro_torch.obs, repro_torch.rollout.replay\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr


def test_chip_smoke_refuses_without_a_gpu():
    """No card (this host, or CUDA hidden): non-zero exit, no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
