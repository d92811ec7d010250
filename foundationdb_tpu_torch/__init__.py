"""PyTorch/CUDA port of foundationdb_tpu.

The interval, point-op and sharded conflict resolvers run on an NVIDIA
H100 through hand-written CUDA kernels (`csrc/`), and on the CPU
through their plain PyTorch versions; a failover wrapper guards them.
The flow runtime (`flow/`), the simulated RPC layer (`rpc/`), the
server roles (`server/`: resolver, proxy, master, logs, storage,
coordinators, cluster controller; `server.SimCluster` runs them all)
and the client (`client/`) commit transactions through them.
`python -m foundationdb_tpu_torch.bench` is the port's bench entry.
The package imports nothing of the JAX package.
"""
