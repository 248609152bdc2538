"""The port loads where JAX does not exist (the GPU machine has none).

A subprocess blocks ``jax`` (``sys.modules['jax'] = None`` makes any import
of it fail) and imports ``linea_stark_tpu_torch``, every one of its
submodules, and ``chip_smoke`` as a module (which must not start a run).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import linea_stark_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
assert not any(k.startswith("linea_stark_tpu.") or k == "linea_stark_tpu"
               for k in sys.modules), "the port imported the JAX package"
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30
