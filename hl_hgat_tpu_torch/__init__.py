"""PyTorch + CUDA port of the HL-HGAT dense-block serving path.

A second package beside the JAX reference (``hl_hgat_tpu``): same batch
layout, same parameters, same numerics within stated tolerances.  It imports
``torch``, numpy and scipy only — never ``jax``, ``flax`` or ``hl_hgat_tpu``.

Entry points (``serving.Predictor``, ``models.presets.zinc_pyr``) run on the
CUDA card unless the caller passes ``device="cpu"``; without a card and
without an explicit CPU device they raise.  The hand-written Hopper kernels
live in ``csrc/`` and are built with ``nvcc`` on first use
(``cuda_build.py``).
"""
