"""Migration helpers (``hl_hgat_tpu/utils``): the reference state-dict importers."""
