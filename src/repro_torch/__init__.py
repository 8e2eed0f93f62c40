"""PyTorch/CUDA port of the ``repro`` serving engine.

A second package beside the JAX reference: the same configs, the same
parameter paths and cache layouts, with every Pallas TPU kernel on the
serving path replaced by a CUDA C++ kernel written for Hopper
(``repro_torch.kernels``).  Entry point: ``repro_torch.serving.LLMEngine``.
"""
