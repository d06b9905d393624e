"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``map_fused`` (``map_decide``, ``evict_stats``) and
``phase1_map``. Sources live in ``csrc/``; ``build`` compiles them."""
