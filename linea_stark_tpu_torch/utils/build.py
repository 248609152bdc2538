"""Build native code from the repository's sources at first use.

Everything lands in ``build/linea_stark_tpu_torch/`` at the repository root
(listed in ``.gitignore``).  A library is rebuilt when any of its sources is
newer than it; the compiler writes to a per-process temporary name that is
then renamed into place, so concurrent test workers never load a half-written
file.  A failed build raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "linea_stark_tpu_torch")


class BuildError(RuntimeError):
    pass


def stale(target: str, sources) -> bool:
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(s) > t for s in sources)


def compile_shared(cmd_prefix: list, sources: list, target: str,
                   deps: list = (), force: bool = False) -> str:
    """Run ``cmd_prefix + ['-o', tmp] + sources`` unless ``target`` is
    fresh (and not ``force``); returns the compiler's combined output (''
    when skipped)."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if not force and not stale(target, list(sources) + list(deps)):
        return ""
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = list(cmd_prefix) + ["-o", tmp] + list(sources)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(
            f"build of {os.path.basename(target)} failed "
            f"(exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    return proc.stdout + proc.stderr
