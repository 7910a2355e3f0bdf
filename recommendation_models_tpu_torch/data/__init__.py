from recommendation_models_tpu_torch.data.layout import (
    Bucket,
    PaddedLayout,
    build_layout,
    csr_arrays,
    layout_from_coo,
)
from recommendation_models_tpu_torch.data.synthetic import (
    synthetic_imc_ratings,
    synthetic_ratings,
    synthetic_side_features,
)

__all__ = [
    "Bucket",
    "PaddedLayout",
    "build_layout",
    "csr_arrays",
    "layout_from_coo",
    "synthetic_imc_ratings",
    "synthetic_ratings",
    "synthetic_side_features",
]
