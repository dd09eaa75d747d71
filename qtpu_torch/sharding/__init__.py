"""Sharding of the port on torch.distributed (port of qtpu/sharding): the
('data', 'model') and ('data', 'pipe'[, 'model']) meshes, Megatron tensor
parallelism as per-rank local shards with explicit collectives, the GPipe
eval, ring attention over a ('seq',) mesh and the multi-process entry.
The submodules import models lazily, so the models can import
`qtpu_torch.sharding.collectives`."""
