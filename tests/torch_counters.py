"""The port's recorder (``hl_hgat_tpu_torch.utils.profiling``) around a block,
for the tests that count what the block launched or prepared.  Imports no
JAX, so the card-only tests can use it under ``--noconftest``."""

import contextlib

import pytest

from hl_hgat_tpu_torch.utils import profiling

LAGUERRE = ("laguerre_dense_fused", "laguerre_terms_dense", "laguerre_dense_fused_bwd",
            "laguerre_terms_dense_bwd")
ELL = ("spmm_ell", "spmm_ell_bwd")


class Recorded:
    """The counter totals of a ``recording`` block: read as they stand
    inside the block, as they ended after it."""

    def __init__(self):
        self.final = None

    def totals(self) -> dict:
        return profiling.snapshot().counters if self.final is None else self.final

    def __getitem__(self, name: str) -> int:
        return self.totals().get(name, 0)

    def launches(self, names=LAGUERRE) -> dict:
        """``{wrapper: launches}`` of the wrappers ``names``."""
        return {name: self[f"launches.{name}"] for name in names}


@contextlib.contextmanager
def recording():
    """The recorder on for the block, its store emptied first; yields the
    block's ``Recorded`` counters.  The recorder is off and empty afterwards,
    so nothing reaches the next test."""
    profiling.disable()
    profiling.reset()
    profiling.enable()
    rec = Recorded()
    try:
        yield rec
    finally:
        profiling.disable()
        rec.final = profiling.snapshot().counters
        profiling.reset()


@pytest.fixture
def recorded():
    """``recording`` around the whole test (import the fixture by name)."""
    with recording() as rec:
        yield rec
