"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``map_fused`` (``map_decide``, ``evict_stats``,
``balance_scan``) and ``phase1_map`` for the scheduler; ``flash_attention``,
``decode_attention`` and ``ssm_scan`` for the model substrate. Sources live
in ``csrc/``; ``build`` compiles them."""
