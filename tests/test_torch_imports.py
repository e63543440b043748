"""The port stands alone: no module under ``src/repro_torch`` (nor
``chip_smoke.py``, nor the card tests) imports ``jax`` or the JAX package
``repro``, and the whole package imports with ``jax`` made unimportable."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port, the smoke script, and the card tests (run where JAX is absent)
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "tests" / "test_torch_cuda.py"]


def _forbidden(module: str) -> bool:
    """``jax``/``jax.*`` and ``repro``/``repro.*`` — by module path, so
    ``repro_torch`` (whose name merely starts with ``repro``) passes."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_training_modules_are_checked():
    """The training slice's modules are among the checked files and import
    without JAX (``test_package_imports_without_jax`` walks them too)."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"optim/__init__.py", "optim/optimizers.py",
            "launch/fl_train_lm.py", "models/lm.py", "launch/train.py",
            "launch/quickstart.py", "launch/stateful_scaffold.py",
            "sharding/__init__.py", "sharding/specs.py", "launch/mesh.py",
            "launch/inputs.py", "launch/hlo_analysis.py",
            "launch/dryrun.py"} <= names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.optim import adamw, fedyogi, sgd\n"
            "from repro_torch.data import make_lm_clients\n"
            "from repro_torch.launch import fl_train_lm\n"
            "from repro_torch.launch import quickstart, stateful_scaffold\n"
            "from repro_torch.launch import train\n"
            "from repro_torch.launch import (dryrun, hlo_analysis, inputs,\n"
            "                                mesh)\n"
            "from repro_torch.sharding import specs\n"
            "from repro_torch.models.lm import make_train_step\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_guard_tells_repro_from_repro_torch():
    assert _forbidden("repro") and _forbidden("repro.core.flat")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.core")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.core, repro_torch.data, repro_torch.kernels\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
