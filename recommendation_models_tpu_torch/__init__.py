"""recommendation_models_tpu_torch — the PyTorch/CUDA port of
``recommendation_models_tpu``.

The JAX package stays the reference; this package runs the same system on
an NVIDIA H100 with PyTorch, and its kernels (the batched Cholesky solves
and the row gather-and-sum) are hand-written CUDA C++ (``csrc/``). It imports neither JAX nor the JAX
package. Entry points run on the CUDA card unless the caller passes
``platform='cpu'``.

Ported so far: the single-device explicit/implicit ALS fit (layout, grams,
solves, sweeps, estimator), serving (``ops.topk``, ``ALS.recommend`` and
``top_n``, ``evaluate`` and ``probes.serving``), the single-device IMC
estimator (fit, cold start, serving; ``probes.imc``), checkpoint and resume
of both estimators (``utils.checkpoint``), the solve variants
(``ops.cholesky`` entries and ``probes.solve_variants``) and the
gather-rate probes (``ops.gather`` and ``probes.dma_gather``,
``gather_rates``, ``ablate_epoch``, ``gather_budget``), the training CLI
(``python -m recommendation_models_tpu_torch.train``), the MovieLens loader
with its native parser (``data.movielens``, ``data.native``), metrics and
profiler traces (``utils.logging``, ``utils.profiling``) and the NumPy
oracles (``oracle``), and the 1-D sharded ALS with its sharded serving
(``parallel``, ``ALS(n_shards=S)``, ``ops.topk.sharded_topk``). Sharded
IMC, the 2-D topology and multi-process runs are still to come
(ROADMAP.md).
"""

__version__ = "0.1.0"

from recommendation_models_tpu_torch.models.als import ALS
from recommendation_models_tpu_torch.models.imc import IMC

__all__ = ["ALS", "IMC", "__version__"]
