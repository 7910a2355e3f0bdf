"""NumPy/SciPy oracles of the port (copies of the JAX package's
``oracle/``): ``OracleALS`` and ``OracleIMC``. The modules import neither
torch nor JAX; importing them through this package runs the port's
``__init__`` (torch), so a host without torch loads ``als_numpy.py`` or
``imc_numpy.py`` by file path."""

from recommendation_models_tpu_torch.oracle.als_numpy import OracleALS
from recommendation_models_tpu_torch.oracle.imc_numpy import OracleIMC

__all__ = ["OracleALS", "OracleIMC"]
