"""PyTorch + CUDA port of HL-HGAT: the packed dense-block layout (serving
and training of ``zinc_pyr``) and the flat COO/ELL layout (graph, node and
link models).

A second package beside the JAX reference (``hl_hgat_tpu``): same batch
layout, same parameters, same numerics within stated tolerances.  It imports
``torch``, numpy and scipy only — never ``jax``, ``flax`` or ``hl_hgat_tpu``.

Entry points (``serving.Predictor``, ``train.Trainer``, ``models.presets``,
the CLI ``python -m hl_hgat_tpu_torch.run``) run on the CUDA card unless the
caller passes ``device="cpu"`` (``--device cpu``); without a card and
without an explicit CPU device they raise.  The hand-written Hopper kernels
live in ``csrc/`` and are built with ``nvcc`` on first use
(``cuda_build.py``).
"""
