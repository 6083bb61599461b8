"""Device-side event identification: vectorized run-length encoding.

Accelerator redesign of the reference's per-cell pandas pipeline
(mhw_filter -> join_gaps -> join_events;
reference: xmhw/identify.py:273-479, 532-536). The pandas ffill/shift chain
becomes a handful of cumulative max/min scans over the time axis, computed
for ALL cells at once on dense ``(time, cell)`` arrays — no Python loops,
no data-dependent shapes, fully jit/shard_map compatible:

* run start for every day  = 1 + (last below-threshold index before it)
  — a cummax scan (the reference's ``idxarr.where(~bthresh).ffill()``,
  identify.py:441);
* run end / run length via the mirrored reverse cummin scan (replaces the
  shift-difference trick at identify.py:446-463);
* events shorter than minDuration are dropped (identify.py:458);
* gap joining (identify.py:273-325): a below-duration stretch of days
  between two kept events, of length <= maxGap, is absorbed — including
  its days — into one merged event whose id is the first event's start
  index. Chains of nearby events merge transitively, exactly like the
  reference's eshift/gaps logic, because merging is re-derived from the
  union mask with the same start-index RLE.

Event ids equal the event's start index (reference: identify.py:466-471),
so labels match the reference bit-for-bit — with ONE deliberate
divergence: the reference's ``ffill().fillna(0)`` (identify.py:441) treats
"no below-threshold day yet" as index 0, so an exceedance run that starts
on day 0 of the record loses its first day (start=1, duration=len-1), and
a leading run of exactly minDuration days is discarded entirely. That is
an artifact, not Hobday semantics; this implementation includes day 0.
Pass ``day0_fillna_quirk=True`` (``reference_quirks=True`` at the detect()
level) to reproduce the artifact for exact output parity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

_I32 = jnp.int32


def _cummax(x):
    return lax.cummax(x, axis=0)


def _rev_cummin(x):
    return lax.cummin(x, axis=0, reverse=True)


def run_geometry(bthresh):
    """Per-day run start/end/length for runs of True in ``bthresh`` (T, C).

    Returns (run_start, run_end, run_len) int32 (T, C); values are only
    meaningful on True days.
    """
    T = bthresh.shape[0]
    idx = lax.broadcasted_iota(_I32, bthresh.shape, 0)
    last_false = _cummax(jnp.where(bthresh, _I32(-1), idx))
    next_false = _rev_cummin(jnp.where(bthresh, _I32(T), idx))
    run_start = last_false + 1
    run_end = next_false - 1
    run_len = next_false - last_false - 1
    return run_start, run_end, run_len


@functools.partial(
    jax.jit,
    static_argnames=("min_duration", "join_gaps", "max_gap",
                     "day0_fillna_quirk"),
)
def mhw_filter(bthresh, min_duration=5, join_gaps=True, max_gap=2,
               day0_fillna_quirk=False):
    """Identify qualifying (possibly gap-joined) events per cell.

    Parameters
    ----------
    bthresh: (T, C) bool — exceedance mask (ts > thresh; NaN compares False,
        matching pandas, reference: identify.py:372)
    min_duration, join_gaps, max_gap: static ints/bool
        (reference defaults: identify.py:415-430)
    day0_fillna_quirk: static bool — reproduce the reference's fillna(0)
        artifact for runs touching day 0 (see module docstring)

    Returns dict of (T, C) arrays:
      event_day   bool — day belongs to a final (merged) event
      event_id    int32 — start index of the day's event (-1 off-event)
      ev_start    int32 — merged event start per day (-1 off-event)
      ev_end      int32 — merged event end per day
      is_start    bool — first day of each merged event
      slot        int32 — dense per-cell event rank (0-based) for segment
                  reductions; only meaningful on event days
      n_events    int32 (C,) — events per cell
    """
    T = bthresh.shape[0]
    big = _I32(4 * T + 64)
    idx = lax.broadcasted_iota(_I32, bthresh.shape, 0)

    run_start, _, run_len = run_geometry(bthresh)
    if day0_fillna_quirk:
        # reference artifact (identify.py:441): the previous-False index of
        # a run touching t0 is fillna'd to 0, shifting its start to 1 and
        # shortening it by one day (day 0 never joins an event)
        leading = run_start == 0
        run_len = jnp.where(leading, run_len - 1, run_len)
        kept = (bthresh & (run_len >= min_duration)
                & ~(leading & (idx == 0)))
    else:
        kept = bthresh & (run_len >= min_duration)

    if join_gaps:
        prev_kept = _cummax(jnp.where(kept, idx, -big))
        next_kept = _rev_cummin(jnp.where(kept, idx, big))
        stretch = next_kept - prev_kept - 1
        join_day = (~kept) & (stretch <= max_gap) & (prev_kept >= 0) & (
            next_kept < T)
        merged = kept | join_day
    else:
        merged = kept

    ev_start, ev_end, _ = run_geometry(merged)
    event_id = jnp.where(merged, ev_start, -1)
    is_start = merged & (idx == ev_start)
    slot = jnp.cumsum(is_start.astype(_I32), axis=0) - 1
    n_events = jnp.sum(is_start.astype(_I32), axis=0)
    return {
        "event_day": merged,
        "event_id": event_id,
        "ev_start": jnp.where(merged, ev_start, -1),
        "ev_end": jnp.where(merged, ev_end, -1),
        "is_start": is_start,
        "slot": slot,
        "n_events": n_events,
    }


def interpolate_na_device(ts, max_gap=None):
    """Linear interpolation of interior NaN runs on device.

    JAX equivalent of ``interpolate_na(max_gap=maxPadLength)``
    (reference: xmhw.py:159-160). Runs strictly between valid samples are
    filled; runs longer than ``max_gap`` (if given) are left as NaN.
    """
    T = ts.shape[0]
    idx = lax.broadcasted_iota(_I32, ts.shape, 0)
    good = jnp.isfinite(ts)
    # previous/next valid index per day
    prev_i = _cummax(jnp.where(good, idx, _I32(-1)))
    next_i = _rev_cummin(jnp.where(good, idx, _I32(T)))
    # value carried from previous/next valid sample (scan with max-keyed
    # carry is wrong for floats; use gather via clipped indices instead)
    prev_ic = jnp.clip(prev_i, 0, T - 1)
    next_ic = jnp.clip(next_i, 0, T - 1)
    prev_v = jnp.take_along_axis(ts, prev_ic, axis=0)
    next_v = jnp.take_along_axis(ts, next_ic, axis=0)
    span = (next_i - prev_i).astype(ts.dtype)
    frac = (idx - prev_i).astype(ts.dtype) / jnp.maximum(span, 1.0)
    interp = prev_v + frac * (next_v - prev_v)
    fillable = (~good) & (prev_i >= 0) & (next_i < T)
    if max_gap is not None:
        run_len = next_i - prev_i - 1
        fillable &= run_len <= max_gap
    return jnp.where(fillable, interp, ts)
