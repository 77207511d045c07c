"""The device's idle share of the traced window, in %: 100 x (1 - busy /
window), busy the union of every device operation's interval."""

from portbench.readers import device_idle_pct as read  # noqa: F401
