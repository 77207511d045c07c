"""Entry points of the port's LM substrate: the train, prefill and decode
steps, the training driver on one device and the serving entry point; and
the analysis mesh the sharded λ-search spreads its rows over
(``sharding``)."""
