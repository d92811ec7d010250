"""PyTorch/CUDA port of foundationdb_tpu.

The interval conflict resolver runs on an NVIDIA H100 through
hand-written CUDA kernels (`csrc/`), and on the CPU through their plain
PyTorch versions. The package imports nothing of the JAX package.
"""
