"""The rules the PyTorch port keeps, checked on its sources and entry points.

  * ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
    any module of the reference package ``repro``;
  * the port mirrors the reference module for module: every port module
    has a reference module at the same relative path (``carry.py`` and the
    kernel build module excepted);
  * ``chip_smoke.py`` exits non-zero and prints no result where CUDA is
    unavailable, and when it stands alone outside a checkout;
  * the entry points run on the card unless the caller names the CPU: the
    LM ``Server`` and the trainer ``train`` without a device raise where
    CUDA is unavailable.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_ONLY = {"carry.py", "kernels/build.py"}


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    """Absolute module names a source imports (relative imports resolve
    inside its own package and are not listed)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
        assert top != "repro", (path, mod)


def test_port_mirrors_the_reference_layout():
    ref = ROOT / "src" / "repro"
    for path in PORT.rglob("*.py"):
        rel = path.relative_to(PORT).as_posix()
        if rel not in PORT_ONLY:
            assert (ref / rel).is_file(), f"{rel} has no reference module"


def test_port_modules_import_without_jax():
    """Importing every port module pulls in neither jax nor repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_server_without_a_device_needs_cuda(monkeypatch):
    from repro_torch.launch.serve import ServeConfig, Server
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(ServeConfig(arch="rwkv6-3b"))
    assert Server(ServeConfig(arch="rwkv6-3b"), device="cpu").device.type \
        == "cpu"


def test_train_without_a_device_needs_cuda(monkeypatch):
    from repro_torch.launch.train import TrainConfig, train
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(TrainConfig(steps=1))
    out = train(TrainConfig(steps=1, global_batch=2, seq_len=8,
                            device="cpu"), progress=lambda _: None)
    assert out["final_step"] == 1
    assert out["params"]["ln_f"].device.type == "cpu"


def _run_smoke(cwd: Path):
    # CUDA hidden: on a machine with a card the script must still refuse
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
