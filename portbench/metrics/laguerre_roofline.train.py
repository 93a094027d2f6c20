"""Σ of the traced Laguerre convs' bounds (``counts.conv_bound_s``) over the
device time of the work those convs launched, found by their ranges."""

from portbench.readers import laguerre_roofline_pct as read  # noqa: F401
