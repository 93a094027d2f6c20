"""The port stands alone: it imports no jax, flax, optax, ml_dtypes or
hl_hgat_tpu module, loads its own build of the host library (never
native/'s), and its entry points refuse to fall back to the CPU without
being asked."""

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
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                        "ml_dtypes", "hl_hgat_tpu"))
    print("MODULES", len(names), "BAD", bad)
    want = ("train.losses", "train.metrics", "train.optim", "train.trainer",
            "profile_training", "profile_serving", "complex.batch", "ops.boundary",
            "ops.spmm", "ops.ell_spmm", "complex.coarsen", "nn.pool", "complex.augment",
            "complex.dense", "data.synthetic", "serving", "data.brain", "data.datasets",
            "models.abcd", "models.hgat", "nn.inception", "native", "data.fast_collate",
            "complex.compact", "data.loader", "data.prefetch", "data.ingest", "data.lrgb",
            "train.checkpoint", "utils.torch_import", "run")
    print("WALKED", all(pkg.__name__ + "." + w in names for w in want))

    # the host library the port loads is its own build, never native/'s
    from hl_hgat_tpu_torch import native
    native.load()
    with open("/proc/self/maps") as f:
        libs = {line.split()[-1] for line in f if "hlhgat_native" in line}
    print("NATIVE", sorted(libs) == [str(native.library_path())],
          all("/_build/" in p and "/native/" not in p for p in libs))

    import torch
    from hl_hgat_tpu_torch import run
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.serving import BrainPredictor, Predictor
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig
    assert not torch.cuda.is_available()
    model, _ = presets.zinc_pyr(channels=(1,), filters=(8,), k=2, keig=4,
                                mlp_channels=(8,), device="cpu")
    for call in (lambda: Predictor(model), lambda: presets.zinc_pyr(),
                 lambda: Trainer(model, TrainerConfig()),
                 lambda: presets.pascalvoc_node(), lambda: presets.pcqm_link(),
                 lambda: presets.zinc_attpool(), lambda: presets.zinc_poolint3_pyr(),
                 lambda: presets.pepfunc_pyr(), lambda: presets.pepfunc_attpool(),
                 lambda: presets.cifar10sp_pyr(), lambda: presets.cifar10sp_attpool(),
                 lambda: presets.tsp_pyr(),
                 lambda: Predictor(model, edge_level=True),
                 lambda: presets.abcd_attpool(), lambda: presets.hgat_attpool(),
                 lambda: BrainPredictor(model, [], []),
                 lambda: run.main(["--benchmark", "zinc", "--synthetic", "--n_synthetic", "4",
                                   "--fold", "0", "--epochs", "1"])):
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
    assert int(modules[1]) >= 46
    assert modules[2:] == ["BAD", "[]"], res.stdout
    assert "WALKED True" in lines, res.stdout
    assert "NATIVE True True" in lines, res.stdout
    assert lines.count("RAISED True") == 17, res.stdout


def test_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|hl_hgat_tpu)\b", re.M)
    files = sorted((ROOT / "hl_hgat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 27
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "ml_dtypes" not in text and "libhlhgat_native.so" not in text, path


def test_every_cuda_source_is_built_and_ships_alone():
    """The build list names exactly the .cu files of csrc/, and a kernel
    source includes nothing but the CUDA toolkit and the package's own
    headers (no torch, no CUTLASS device GEMM, no other library)."""
    from hl_hgat_tpu_torch import cuda_build

    csrc = ROOT / "hl_hgat_tpu_torch" / "csrc"
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(cuda_build.SOURCES)
    assert {"laguerre_dense", "laguerre_dense_bwd", "laguerre_band",
            "ell_spmm"} <= set(cuda_build.SOURCES)
    own = {p.name for p in csrc.glob("*.cuh")}
    allowed = {"cuda_bf16.h", "cuda_runtime.h", "cstddef"} | own
    for path in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        includes = re.findall(r'^\s*#include\s+[<"]([^>"]+)[>"]', path.read_text(), re.M)
        assert includes and set(includes) <= allowed, (path.name, includes)
    # an edited shared header changes every library's name, so it is rebuilt
    a = cuda_build.library_path("laguerre_dense").name
    assert a.startswith("liblaguerre_dense-") and a.endswith(".so")
