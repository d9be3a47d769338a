"""Distribution substrate: gradient compression (tensor arithmetic, no
process group).  Sharding waits for the port's multi-card work."""
from repro_torch.distributed import compression

__all__ = ["compression"]
