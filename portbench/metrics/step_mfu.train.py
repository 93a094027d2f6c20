"""The window's training FLOPs (the reference's count) over the window, as a
share of the card's float32 peak."""

from portbench.readers import mfu_pct as read  # noqa: F401
