"""deepsphere_tpu — a JAX framework for spherical CNNs on HEALPix-sampled
maps.

A from-scratch re-design of the capabilities of ``deepsphere-cosmo-tf2``
(graph convolutions via polynomials of the sphere-graph Laplacian, NEST
hierarchy pooling, graph attention, Gaussian smoothing, model assembly and
visualization) built on jax / optax with a small in-repo module system
(:mod:`.nn.core`), XLA-compiled compute and ``jax.sharding`` scale-out.

Public surface parity with the reference package
(``/root/reference/src/deepsphere/__init__.py``): ``HealpyGCNN``, ``logger``,
``__version__`` at top level, everything else via submodules.
"""

from ._logger import logger
from .models import HealpyGCNN

__version__ = "0.1.0"

__all__ = ["HealpyGCNN", "logger", "__version__"]

from . import graph, models, nn, ops, serve, sphere, utils  # noqa: E402

# keep the reference import idiom working: `from deepsphere_tpu import healpy_layers as hp_nn`
from .nn import healpy_layers  # noqa: E402
