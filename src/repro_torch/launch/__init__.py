"""Entry points of the port's LM substrate: the train, prefill and decode
steps, the training driver and the serving entry point (on one device or
an LM mesh); the meshes (``mesh``: the production and local
``DeviceMesh``es) and their sharding rules (``sharding``, which also holds
the analysis mesh the sharded λ-search spreads its rows over); and the
elastic controller (``elastic``)."""
