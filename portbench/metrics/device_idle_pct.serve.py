"""Share of the window's time in which no kernel, copy or set runs on the
device: the traced units' busy time (the union of their device intervals)
over the untraced window's time, a unit each."""

from portbench.readers import device_idle_pct as read  # noqa: F401
