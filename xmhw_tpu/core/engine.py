"""The one place that picks the device engine, from the platform.

* ``"cpu"``: the plain XLA engine. float64 climatologies use the
  comparator sort for exact reference parity.
* ``"gpu"``: the same XLA engine, except that float32 climatologies run
  the Pallas percentile kernel (ops/pallas/doy_quantile.py, Triton route).

No user option picks the engine. Tests reach the kernel path on the CPU by
monkeypatching :func:`device_engine` and running the kernel in interpret
mode.
"""

from __future__ import annotations

import jax

ENGINES = ("cpu", "gpu")


def device_engine() -> str:
    """Engine for the default JAX backend; any platform other than the
    CPU or an NVIDIA GPU is an error."""
    platform = jax.default_backend()
    if platform not in ENGINES:
        raise RuntimeError(
            f"xmhw_tpu has no device engine for platform {platform!r}: "
            f"it runs on {' or '.join(ENGINES)}")
    return platform
