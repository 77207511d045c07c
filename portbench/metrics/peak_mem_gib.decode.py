"""The allocator's peak over the window, in GiB: ``max_memory_allocated``
after a reset at the end of set-up (the weights included)."""

from portbench.readers import peak_mem_gib as read  # noqa: F401
