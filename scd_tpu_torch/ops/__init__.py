"""Device ops: the hand-written CUDA kernels (``topk``, ``em``, ``w8a8``),
their plain PyTorch versions, and the plain pieces around them
(``distance``, ``segment``, ``kpp``)."""
