"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their wrappers,
their plain PyTorch versions (``ref``) and the dispatch (``ops``)."""
