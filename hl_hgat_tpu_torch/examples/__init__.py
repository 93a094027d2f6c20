"""The JAX package's three example programs on the port (``examples/``):
``brain_demo``, ``figures`` and ``gp_brain``, each run as
``python -m hl_hgat_tpu_torch.examples.<name>``.  Importing one runs
nothing."""
