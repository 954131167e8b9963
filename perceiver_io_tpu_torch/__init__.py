"""PyTorch/CUDA port of ``perceiver_io_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports neither JAX
nor the JAX package; its TPU kernels become hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` at first use. Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``.
"""
