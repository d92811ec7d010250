"""PyTorch/CUDA port of foundationdb_tpu.

The interval, point-op and sharded conflict resolvers run on an NVIDIA
H100 through hand-written CUDA kernels (`csrc/`), and on the CPU
through their plain PyTorch versions; a failover wrapper guards them.
The flow runtime (`flow/`), the simulated RPC layer (`rpc/`) and the
resolver role (`server/resolver_role.py`) serve ResolveRequests
through them. `python -m foundationdb_tpu_torch.bench` is the port's
bench entry. The package imports nothing of the JAX package.
"""
