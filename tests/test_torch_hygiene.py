"""The port stands alone: no file of ``repro_torch``, ``chip_smoke.py`` or
the torch examples imports JAX or the JAX package, and the port, the
modules ``chip_smoke.py`` reaches and the torch examples import with both
blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + EXAMPLES
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
            "import repro_torch.serve, repro_torch.obs.history\n"
            "import repro_torch.obs.log, repro_torch.launch.serve\n"
            "import repro_torch.core.agent, repro_torch.core.replay\n"
            "import repro_torch.mec.scenarios\n"
            "import repro_torch.sweep, repro_torch.sharding\n"
            "import repro_torch.sweep.runner, repro_torch.sharding.fleet\n"
            "import repro_torch.launch.sweep, repro_torch.launch.history\n"
            "import repro_torch.obs.compile, repro_torch.obs.regress\n"
            "import repro_torch.pop, repro_torch.pop.population\n"
            "import repro_torch.pop.pbt, repro_torch.pop.curriculum\n"
            "import repro_torch.pop.trainer, repro_torch.launch.pop\n"
            "import repro_torch.obs.profile, repro_torch.obs.cost\n"
            "import repro_torch.launch.profile, repro_torch.kernels.cost\n"
            "import repro_torch.data, repro_torch.vgg, repro_torch.nn\n"
            "import repro_torch.launch.train, repro_torch.optim.schedules\n"
            "import repro_torch.launch.specs, repro_torch.launch.analysis\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.__main__\n"
            "import repro_torch.launch.serve_bench, repro_torch.obs.rows\n"
            "import repro_torch.figures, repro_torch.figures.__main__\n"
            "import repro_torch.figures.convergence\n"
            "import repro_torch.figures.learning\n"
            "import repro_torch.figures.vary_devices\n"
            "import repro_torch.figures.vary_capacity\n"
            "import repro_torch.figures.vary_inference_time\n"
            "import repro_torch.figures.imperfect_csi\n"
            "import repro_torch.models.lm, repro_torch.nn.initializers\n"
            "import repro_torch.kernels.decode_attention\n"
            "import repro_torch.kernels.flash_attention\n"
            "import importlib.util\n"
            "for path in sys.argv[1:]:\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code, *map(str, EXAMPLES)],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr
    assert len(EXAMPLES) == 7


def test_chip_smoke_refuses_without_a_gpu():
    """No card (this host, or CUDA hidden): non-zero exit, no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_launch_serve_runs_on_the_cpu():
    """``python -m repro_torch.launch.serve --device cpu`` serves its
    slots and prints its summary."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen1_5_0_5b", "--reduced", "--slots", "2"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["slot", "0"],
                                                     ["slot", "1"]]
    assert lines[-1].startswith("summary: {'ssp': ")
