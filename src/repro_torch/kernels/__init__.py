"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built by
``build``), their plain PyTorch oracles (``ref``) and the dispatch layer
(``ops``)."""
