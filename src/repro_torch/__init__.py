"""PyTorch/CUDA port of the FedTune system in ``repro``.

The JAX package ``repro`` is the reference; this package does the same work
in PyTorch, with hand-written Hopper kernels (``kernels/csrc``) where the
reference has Pallas kernels.  It imports neither ``jax`` nor ``repro``:
the framework-free modules it needs are copies kept under the same relative
paths.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises when no GPU is present.
"""
