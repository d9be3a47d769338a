"""Distribution: gradient compression (tensor arithmetic, no process
group), the sharding rules and specs, and the collectives of the sharded
MoE."""
from repro_torch.distributed import comm, compression, sharding

__all__ = ["comm", "compression", "sharding"]
