"""PyTorch/CUDA port of liso_tpu for one NVIDIA H100.

The JAX package `liso_tpu` is the reference. This package imports torch and
numpy only: nothing of JAX and nothing of `liso_tpu`. Entry points build
their models on the card (`cuda`) unless the caller passes `device="cpu"`.
Every Pallas TPU kernel on a ported path has a hand-written CUDA C++ kernel
in `kernels/`, launched for CUDA tensors, and a plain PyTorch version beside
it in the same module, used for CPU tensors and, on the card, inside
`kernels.plain_versions()`.
"""
