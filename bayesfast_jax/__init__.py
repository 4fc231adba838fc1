"""bayesfast_jax — accelerator-native Bayesian posterior sampling and evidence
estimation.

A ground-up JAX/XLA re-design with the capabilities of the reference
``bayesfast`` package (polynomial surrogate models + NUTS/HMC sampling +
Gaussianized Bridge Sampling evidence): chains are a sharded array axis in a
single jitted program instead of worker processes; Cython kernels become
batched device kernels; mutable traces become functional scan carries.
"""

__version__ = '0.1.0'

from . import config  # configures matmul precision — keep first
from . import utils
from . import ops
from . import core
from . import samplers
from . import parallel
from .core import recipe  # ``bf.recipe.OptimizeStep`` etc., as in the reference
from .core import *        # noqa: F401,F403
from .samplers import *    # noqa: F401,F403

try:  # optional heavier subpackages (later phases)
    from . import modules
    from . import transforms
    from . import evidence
    from .modules import *     # noqa: F401,F403
    from .evidence import *    # noqa: F401,F403
except ImportError:  # pragma: no cover - during early phases
    pass
