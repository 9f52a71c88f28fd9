"""cudasw4_tpu_torch and chip_smoke.py import neither JAX nor cudasw4_tpu
(nor the root benchmarks/ scripts);
importing them builds no kernel, compiles no native library and starts no
process group.

Each check imports in a fresh interpreter whose PYTHONPATH is the repo
alone (the login profile's site dir can import JAX on its own).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import cudasw4_tpu_torch
names = ["cudasw4_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(cudasw4_tpu_torch.__path__, "cudasw4_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch.distributed as dist
from cudasw4_tpu_torch.ops import cuda_lib
from cudasw4_tpu_torch import native
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "cudasw4_tpu" or m.startswith("cudasw4_tpu.")
             or m == "benchmarks" or m.startswith("benchmarks."))
print(len(names))
print(",".join(bad))
print(int(dist.is_available() and dist.is_initialized()), int(cuda_lib._lib is not None),
      int(native._tried))
"""


def _probe():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.split("\n")
    return int(lines[0]), lines[1], lines[2]


def test_port_imports_no_jax_and_no_jax_package():
    count, bad, started = _probe()
    assert count >= 20  # every module of the port was imported
    assert bad == "", f"imported: {bad}"
    assert started == "0 0 0", \
        "an import started a process group, loaded the kernels or built the native library"


@pytest.mark.parametrize("cmd", [
    [sys.executable, "-m", "cudasw4_tpu_torch.cli.align", "--help"],
    [sys.executable, "-m", "cudasw4_tpu_torch.cli.makedb"],
    [sys.executable, "-m", "cudasw4_tpu_torch.cli.gridsearch", "gridsearch", "--help"],
    [sys.executable, "-m", "cudasw4_tpu_torch.cli.modifydb"],
])
def test_cli_entry_points_start_without_jax(cmd):
    env = dict(os.environ, PYTHONPATH=REPO)
    code = (
        "import runpy, sys; sys.argv = %r; "
        "sys.modules['jax'] = None; sys.modules['cudasw4_tpu'] = None; "
        "runpy.run_module(%r, run_name='__main__')" % (cmd[3:] or ["x"], cmd[2])
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("tool", ["colpass", "sweepdiag", "tremblbench", "dbbench", "bench"])
def test_engine_tools_import_without_jax(tool):
    """The engine tools and the benchmark entry point import with JAX, the
    JAX package and benchmarks/ blocked, and their usage texts name their
    module."""
    env = dict(os.environ, PYTHONPATH=REPO)
    name = "cudasw4_tpu_torch.bench" if tool == "bench" else f"cudasw4_tpu_torch.tools.{tool}"
    code = (
        "import importlib, sys; "
        "sys.modules['jax'] = None; sys.modules['cudasw4_tpu'] = None; "
        "sys.modules['benchmarks'] = None; "
        f"print(importlib.import_module({name!r}).__doc__)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"python -m {name}" in r.stdout
