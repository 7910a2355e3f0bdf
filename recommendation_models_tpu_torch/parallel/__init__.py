"""Sharded programs of the port: the 1-D and 2-D meshes in one process
(``mesh``), the exchange plans (``exchange``), the sharded ALS
(``sharded_als``), the observation-parallel ALS (``hybrid_als``) and the
analytic scaling model (``scaling``)."""

from recommendation_models_tpu_torch.parallel.mesh import (
    get_hybrid_mesh, get_mesh, initialize_distributed,
)
from recommendation_models_tpu_torch.parallel.exchange import (
    ExchangePlan, build_exchange_plan,
)
from recommendation_models_tpu_torch.parallel.sharded_als import (
    ShardedALSProgram,
)
from recommendation_models_tpu_torch.parallel.hybrid_als import (
    HybridALSProgram, split_layout_slices,
)

__all__ = [
    "get_mesh",
    "get_hybrid_mesh",
    "initialize_distributed",
    "ExchangePlan",
    "build_exchange_plan",
    "ShardedALSProgram",
    "HybridALSProgram",
    "split_layout_slices",
]
