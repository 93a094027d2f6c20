"""The port stands alone: it imports no jax, flax or hl_hgat_tpu module,
and its entry points refuse to fall back to the CPU without being asked."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import hl_hgat_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "hl_hgat_tpu"))
    print("MODULES", len(names), "BAD", bad)

    import torch
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.serving import Predictor
    assert not torch.cuda.is_available()
    model, _ = presets.zinc_pyr(channels=(1,), filters=(8,), k=2, keig=4,
                                mlp_channels=(8,), device="cpu")
    for call in (lambda: Predictor(model), lambda: presets.zinc_pyr()):
        try:
            call()
        except RuntimeError as err:
            print("RAISED", "device='cpu'" in str(err))
        else:
            print("NO RAISE")
""")


def test_port_imports_no_jax_and_refuses_silent_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    modules = [ln for ln in lines if ln.startswith("MODULES")][0].split()
    assert int(modules[1]) >= 20
    assert modules[2:] == ["BAD", "[]"], res.stdout
    assert lines.count("RAISED True") == 2, res.stdout


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|hl_hgat_tpu)\b", re.M)
    files = sorted((ROOT / "hl_hgat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        assert not pattern.search(path.read_text()), path
