"""PyTorch/CUDA port of the Echo reproduction.

Mirrors the module layout of the JAX package ``repro`` and imports nothing
from it. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the kernels (split-K and legacy paged decode, chunked
prefill attention, the SSD chunk scan, the RG-LRU scan) are hand-written
CUDA C++ for Hopper
(``repro_torch/kernels/csrc``) with plain PyTorch versions for CPU tensors.
"""
