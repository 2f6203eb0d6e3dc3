"""Visualization: map projections and filter plots.

Replacement for the reference visualization layer
(``/root/reference/src/deepsphere/plot.py`` and the plotting methods of
``healpy_networks.py:190-385``) with no healpy/pygsp dependency — the
projections are computed from this package's own HEALPix geometry.
"""

from .projections import gnomview, mollview, gnomonic_pixels, mollweide_pixels
from .filters import (
    SphericalFilterBank,
    get_index_equator,
    plot_filters_gnomonic,
    plot_filters_section,
)

__all__ = [
    "gnomview",
    "mollview",
    "gnomonic_pixels",
    "mollweide_pixels",
    "SphericalFilterBank",
    "get_index_equator",
    "plot_filters_gnomonic",
    "plot_filters_section",
]
