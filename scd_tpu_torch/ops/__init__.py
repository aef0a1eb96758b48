"""Device ops: the two hand-written CUDA kernels of the main path
(``topk``, ``em``), their plain PyTorch versions, and the plain pieces
around them (``distance``, ``segment``, ``kpp``)."""
