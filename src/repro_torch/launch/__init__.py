"""Entry points of the port's LM substrate: the prefill and decode steps and
the serving entry point (training waits for a later slice); and the
analysis mesh the sharded λ-search spreads its rows over (``sharding``)."""
