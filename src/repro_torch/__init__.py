"""PyTorch/CUDA port of the SNN compile-and-admit system in ``repro``.

The JAX package ``repro`` is the reference; this package owns its code and
never imports it (nor JAX).  Host graph construction stays numpy; the
batched max-plus analysis runs on a ``torch.device`` with hand-written CUDA
kernels (``csrc/``) and their plain PyTorch versions (``kernels/ref.py``).
"""
