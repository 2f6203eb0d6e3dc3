"""Global numerical configuration.

``matmul_precision`` controls the XLA dot precision used by every matmul /
einsum in the compute path.  The default is ``"highest"`` (full float32)
so the framework meets the <1e-5 per-layer parity target vs the float32
TF2 reference; on GPUs ``"default"`` lets float32 matmuls run in TF32 on
the tensor cores (about three decimal digits) for throughput.
"""

from __future__ import annotations

import jax

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}

matmul_precision: str = "highest"


def set_matmul_precision(name: str):
    global matmul_precision
    if name not in _PRECISIONS:
        raise ValueError(f"Unknown precision {name}; choose from {list(_PRECISIONS)}")
    matmul_precision = name


def precision():
    return _PRECISIONS[matmul_precision]
