"""PyTorch/CUDA port of foundationdb_tpu.

The interval and point-op conflict resolvers run on an NVIDIA H100
through hand-written CUDA kernels (`csrc/`), and on the CPU through
their plain PyTorch versions; a failover wrapper guards them. The package imports nothing of the JAX package.
"""
