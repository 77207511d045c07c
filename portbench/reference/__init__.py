"""Plain float32 PyTorch models that the benchmark holds the port against.

Nothing here imports the program under test: the weights and tokens come
from the benchmark, the architecture from the configuration's ``model``
block.
"""
