"""Observability: timing, JAX profiler traces, and logging.

The reference has no tracing/profiling support (SURVEY §5); the
equivalents here are:

* :func:`timed` — wall-clock timing context with device synchronization
  (``jax.block_until_ready`` on the supplied outputs), the JAX analogue of
  a CUDA-event timer;
* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace of the XLA ops;
* module logger — replaces the reference's bare prints
  (reference: identify.py:130, stats.py:154-158).
"""

from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger("xmhw_tpu")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(name)s %(levelname)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


@contextlib.contextmanager
def timed(label: str, sync=None, log=True):
    """Time a block; ``sync`` (array / pytree) is blocked on before
    stopping the clock so async dispatch doesn't lie.

    >>> with timed("detect", sync_holder) as t: ...
    """
    import jax

    holder = {}
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if sync is not None:
            jax.block_until_ready(sync)
        if "sync" in holder:
            jax.block_until_ready(holder["sync"])
        holder["seconds"] = time.perf_counter() - t0
        if log:
            logger.info("%s: %.3f s", label, holder["seconds"])


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a JAX profiler trace (view with TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
