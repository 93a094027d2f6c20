#!/usr/bin/env python3
"""``chip_smoke.py`` with torch's deterministic algorithms, in the process
and in every rank that it spawns.

    python3 scripts/chip_smoke_deterministic.py --parallel-only

The spawned ranks run this module's top level again (as ``__mp_main__``),
so the setting reaches them too.  On the card ``index_add_`` then sums in
a fixed order: two single-process runs give the same bits, and phase 13's
graph-parallel step differs from the single process only by its
partitioned sums, the same way in every run.  The flags are
``chip_smoke.py``'s.  Needs a card.
"""

from __future__ import annotations

import pathlib
import sys

import torch

torch.use_deterministic_algorithms(True, warn_only=True)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import chip_smoke

    sys.exit(chip_smoke.main())
