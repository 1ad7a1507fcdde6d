"""Distribution utilities: logical-axis sharding rules over a device mesh
(port of ``repro.dist``)."""
from repro_torch.dist import sharding

__all__ = ["sharding"]
