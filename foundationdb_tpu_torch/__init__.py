"""PyTorch/CUDA port of foundationdb_tpu.

The interval and point-op conflict resolvers run on an NVIDIA H100
through hand-written CUDA kernels (`csrc/`), and on the CPU through
their plain PyTorch versions; a failover wrapper guards them.
`python -m foundationdb_tpu_torch.bench` is the port's bench entry.
The package imports nothing of the JAX package.
"""
