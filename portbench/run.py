"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench.run --workload zinc_pyr.train.b2048 --seed 7 \\
        --seconds 10 --trace 0

Loads the cell's files (``spec.py``), sets up (inputs and weights from the
seed, the port built and warmed up), measures for ``--seconds``, checks
the timed path's outputs against the plain reference, and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, the cell's end-to-end
metrics (``--trace 0``) or per-layer metrics (``--trace 1``, which also
traces a few units after the window in one profiler session), ``device``,
with ``--trace 1`` a ``breakdown``, and last the ``checks``: each number
compared, beside its limit (also the last lines on standard error).  Exits
non-zero with no result when there is no card, too few cards, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hl_hgat_tpu")
CACHE = ROOT / ".portbench_cache"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def result_line(cell, rec, traced: bool) -> dict:
    from portbench import harness

    metrics = {}
    for name, (entry, reader) in cell.metrics.items():
        value = reader.read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    out = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": harness.device_info(rec)}
    if traced and rec.trace is not None:
        out["breakdown"] = {"device_ops": rec.trace.device_ops,
                            "idle_gaps": rec.trace.idle_gaps}
    out["checks"] = {k: {"value": v if v == v else None, "limit": lim}
                     for k, (v, lim) in rec.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"

    from portbench import harness, spec

    cell = spec.load_cell(ROOT, args.workload, tempfile.gettempdir(), traced=bool(args.trace))
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the configurations state float32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"portbench: {cell.name} seed {args.seed} on {harness.power_limit()}", file=sys.stderr,
          flush=True)
    rec = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    line = result_line(cell, rec, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
