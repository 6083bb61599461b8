"""xmhw_tpu — accelerator-native marine heatwave detection (JAX/XLA/Pallas).

A ground-up rebuild of the capabilities of coecms/xmhw (Hobday et al. 2016
marine-heatwave detection) for accelerators: dense (time, cell) arrays,
jit-compiled kernels, cell-axis sharding over a device mesh, and a
lightweight labeled-array + NetCDF shell replacing xarray/dask.

Public API (reference parity: README.rst:16-21):
    threshold()      day-of-year percentile/mean climatology
    detect()         MHW event identification + ~30 per-event properties
    block_average()  year-block statistics
    mhw_rank()       per-property ranks and return periods
"""

import os as _os

# compile-cache location used when JAX_COMPILATION_CACHE_DIR is not set:
# fixed and inside the checkout, so every process of one checkout shares it
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir():
    """Where the persistent XLA compile cache (and stream.py's K table)
    lives: ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself),
    else :data:`DEFAULT_CACHE_DIR`."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def _enable_compile_cache():
    """Persistent XLA compile cache for every process importing the
    package, so first-call latency is paid once per checkout (or
    pre-seeded with ``xmhw-tpu warmup``), not once per process.

    Accelerator processes only: XLA:CPU cache entries are AOT results
    pinned to the compiling machine's ISA, so a CPU-only process (e.g.
    the test suite) sets nothing, and XMHW_COMPILE_CACHE=0 opts out.
    Config-only: no backend is initialized here."""
    import jax

    if _os.environ.get("XMHW_COMPILE_CACHE") == "0":
        return
    platforms = (_os.environ.get("JAX_PLATFORMS", "")
                 or getattr(jax.config, "jax_platforms", None) or "")
    if platforms.strip().lower() == "cpu":
        return
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

from .api import detect, flip_cold, land_check, threshold
from .exception import XmhwException
from .stats_api import block_average, mhw_rank
from .stream import (merge_grid_band_files, stream_block_average,
                     stream_detect, stream_rank, stream_run,
                     stream_threshold)
from .xrlite import (DataArray, Dataset, TimeIndex, open_dataset,
                     save_dataset, to_dataframe, to_xarray)

__version__ = "0.1.0"

__all__ = [
    "DataArray",
    "Dataset",
    "TimeIndex",
    "XmhwException",
    "block_average",
    "detect",
    "flip_cold",
    "land_check",
    "merge_grid_band_files",
    "mhw_rank",
    "open_dataset",
    "save_dataset",
    "stream_block_average",
    "stream_detect",
    "stream_rank",
    "stream_run",
    "stream_threshold",
    "threshold",
    "to_dataframe",
    "to_xarray",
    "__version__",
]
