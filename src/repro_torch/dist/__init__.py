"""repro_torch.dist — the port of ``repro.dist``, so far only the
signplane aggregation identity the sim engine uses
(:func:`signplane_weighted_aggregate`)."""
from .compressor import lo_plane, signplane_weighted_aggregate

__all__ = ["lo_plane", "signplane_weighted_aggregate"]
