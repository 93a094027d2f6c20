"""The forward FLOPs (the reference's count) of the requests served in the
window over the window, as a share of the card's float32 peak.  Offered
above capacity, the requests served follow the service's speed."""

from portbench.readers import mfu_pct as read  # noqa: F401
