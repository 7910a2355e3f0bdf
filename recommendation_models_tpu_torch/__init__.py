"""recommendation_models_tpu_torch — the PyTorch/CUDA port of
``recommendation_models_tpu``.

The JAX package stays the reference; this package runs the same system on
an NVIDIA H100 with PyTorch, and its kernels (the batched Cholesky solves
and the row gather-and-sum) are hand-written CUDA C++ (``csrc/``). It imports neither JAX nor the JAX
package. Entry points run on the CUDA card unless the caller passes
``platform='cpu'``.

Every module of the JAX package has its counterpart here: the ALS fit,
explicit and implicit, on one device, sharded over a 1-D mesh (every
exchange) or over the 2-D observation-parallel mesh; IMC on one device or
sharded; serving (``ops.topk``, ``ALS.recommend``, ``evaluate``);
checkpoints (``utils.checkpoint``); the training CLI (``python -m
recommendation_models_tpu_torch.train``) with the MovieLens loader and its
native parser; metrics, traces and the NumPy oracles; the multi-process
runtime (``parallel.mesh.initialize_distributed``, a gloo process group
for the mesh's collectives); and the probes (``probes``).

``ALS`` and ``IMC`` load at first use, so a process that needs neither
(a probe, a worker of a multi-process run) does not pay for scikit-learn's
import.
"""

__version__ = "0.1.0"

__all__ = ["ALS", "IMC", "__version__"]


def __getattr__(name):
    if name == "ALS":
        from recommendation_models_tpu_torch.models.als import ALS
        return ALS
    if name == "IMC":
        from recommendation_models_tpu_torch.models.imc import IMC
        return IMC
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
