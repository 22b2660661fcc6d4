"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` holds the entry points; ``fed_reduce``, ``fed_aggregate``,
``flash_attention`` and ``rglru_scan`` are the kernel modules (each with
its ``launches`` counter), ``ref`` the plain versions and ``build`` the
nvcc build of ``csrc/``.
"""
