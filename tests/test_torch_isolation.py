"""PyTorch port: it imports neither JAX nor the JAX package.

A machine with a GPU need not have JAX, so the port and chip_smoke.py must
run without it; only the port's tests import JAX, as the oracle.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "f1tenth_gym_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+f1tenth_gym_tpu\b(?!_torch)"
    r"|from\s+f1tenth_gym_tpu(\.|\s)(?!_torch))",
    re.MULTILINE)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_import_with_jax_blocked():
    """Import every port module with ``jax`` unimportable, and with cv2,
    Pillow, PyYAML, pygame and gymnasium too (the card's machine has none
    of them: the port imports pygame and gymnasium only where it uses
    them); no module of f1tenth_gym_tpu may be loaded afterwards."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'cv2', 'PIL', 'yaml', 'pygame', 'gymnasium'):\n"
        "    sys.modules[name] = None\n"
        "import f1tenth_gym_tpu_torch as P\n"
        "for mod in pkgutil.walk_packages(P.__path__, 'f1tenth_gym_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = [m for m in sys.modules if m == 'f1tenth_gym_tpu' or "
        "m.startswith('f1tenth_gym_tpu.')]\n"
        "assert not bad, bad\n"
        "assert all(sys.modules[n] is None for n in "
        "('jax', 'cv2', 'PIL', 'yaml', 'pygame', 'gymnasium'))\n"
        "print('ok', len([m for m in sys.modules if m.startswith("
        "'f1tenth_gym_tpu_torch')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert int(proc.stdout.split()[1]) >= 30


def test_no_jax_imports_in_port_sources():
    files = _port_files()
    assert len(files) >= 20
    for path in files:
        with open(path) as f:
            src = f.read()
        m = FORBIDDEN.search(src)
        assert m is None, f"{path}: {m.group(0).strip()}"


def test_forbidden_pattern_catches_jax_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "from f1tenth_gym_tpu.ops import lidar",
                 "import f1tenth_gym_tpu", "  from f1tenth_gym_tpu import x"):
        assert FORBIDDEN.search(line), line
    for line in ("import jaxlib", "from f1tenth_gym_tpu_torch import P",
                 "import f1tenth_gym_tpu_torch.ops", "# uses jax"):
        assert not FORBIDDEN.search(line), line
