"""PyTorch/CUDA port of consensus_specs_tpu's batched BLS12-381 verification.

The JAX package ``consensus_specs_tpu`` is the reference; this package runs
the same field-ALU VM programs on an NVIDIA H100 through hand-written CUDA
kernels (``csrc/``), and on the CPU through their plain PyTorch versions.
It imports neither jax nor any module of the JAX package.
"""
