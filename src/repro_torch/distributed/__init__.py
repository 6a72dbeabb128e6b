"""Multi-rank pieces of the port: fault-tolerance decisions (``elastic``),
the collectives over a mesh axis (``collectives``, the one module that
calls ``torch.distributed`` for a step's data) and the reference's
sharding rules with the cutter and the tensor-parallel view the sharded
forward reads (``sharding``).  The training half's modules
(``act_sharding``, ``pipeline``, ``compression``) wait for ROADMAP A10."""
