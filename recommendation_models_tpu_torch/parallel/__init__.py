"""Sharded programs of the port: the 1-D mesh in one process
(``mesh``), the exchange plans (``exchange``), the sharded ALS
(``sharded_als``) and the analytic scaling model (``scaling``)."""

from recommendation_models_tpu_torch.parallel.mesh import (
    get_mesh, initialize_distributed,
)
from recommendation_models_tpu_torch.parallel.exchange import (
    ExchangePlan, build_exchange_plan,
)
from recommendation_models_tpu_torch.parallel.sharded_als import (
    ShardedALSProgram,
)

__all__ = [
    "get_mesh",
    "initialize_distributed",
    "ExchangePlan",
    "build_exchange_plan",
    "ShardedALSProgram",
]
