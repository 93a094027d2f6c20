"""Nothing the benchmark imports, or loads while a small run of each driver
goes on, has the top-level name ``jax``, ``jaxlib``, ``flax`` or
``hl_hgat_tpu`` (compared whole: the port's ``hl_hgat_tpu_torch`` begins
with the JAX package's name), and the reference imports nothing of the port.
Each check runs in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "hl_hgat_tpu"}


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_port():
    top = _modules_after(
        "import portbench.reference.ops, portbench.reference.zinc_pyr, "
        "portbench.reference.hgat_attpool, portbench.reference.train")
    assert not top & (FORBIDDEN | {"hl_hgat_tpu_torch"})


def test_benchmark_loads_no_jax():
    code = """
import pathlib, tempfile
from portbench import calibrate, run, spec
from portbench.tests.conftest import small_cell
for p in sorted(pathlib.Path('portbench').rglob('*.py')):
    if 'tests' not in p.parts:
        spec.load_module(p.resolve())
import hl_hgat_tpu_torch.data.brain, hl_hgat_tpu_torch.models.hgat
for name in ('zinc_pyr.train.b2048', 'zinc_pyr.serve.r1024'):
    cell = small_cell(name, tempfile.mkdtemp(), traced=True)
    cell.driver.run(cell, 3, 0.5, True, 'cpu', 0.0, workers=1)
"""
    top = _modules_after("if __name__ == '__main__':\n" + "".join(
        "    " + line + "\n" for line in code.strip().splitlines()))
    assert "hl_hgat_tpu_torch" in top
    assert not top & FORBIDDEN
