"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch between them (``ops``).  Kernel sources live in ``csrc/``
and are built at first use by ``build``."""
