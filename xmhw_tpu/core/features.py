"""Device-side event feature engine: segment reductions on (time, cell).

Accelerator redesign of the reference's per-cell pandas groupby feature
engine (mhw_df -> agg_df -> properties -> onset_decline;
reference: xmhw/features.py:22-295). The 30-output pandas groupby becomes
scatter-based segment reductions keyed by (event slot, cell):

* per-day derived columns (relSeas/relThresh/severity/categories,
  reference: features.py:44-68) are dense (T, C) elementwise ops;
* sums/means/maxes are one scatter-add/scatter-max each; variances use the
  numerically stable two-pass form (mean first, then squared deviations)
  to stay accurate in float32 (pandas computes in float64);
* first/last/argmax positions are scatter-min/max of day indices, matching
  pandas ``first``/``last`` (first non-NaN) and ``idxmax``/``np.argmax``
  (first max position) semantics (reference: features.py:114-152);
* onset/decline rates are closed-form per event from the segment outputs
  (reference: features.py:196-295), reproducing the reference's exact
  boundary rules (events touching the series ends, peak-on-first/last-day
  half-day offsets).

Event tables are fixed-size (K slots per cell, NaN padded) so shapes stay
static under jit; K is chosen by the caller from a cheap counting pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .events import mhw_filter

_I32 = jnp.int32


def _scatter_shape(K, C):
    # one extra trash row absorbs off-event days and overflow slots
    return (K + 1, C)


def _seg_sum(x, slot, cols, K, C):
    return jnp.zeros(_scatter_shape(K, C), x.dtype).at[slot, cols].add(x)[:-1]


def _seg_max(x, slot, cols, K, C, neutral):
    out = jnp.full(_scatter_shape(K, C), neutral, x.dtype)
    return out.at[slot, cols].max(x)[:-1]


def _seg_min(x, slot, cols, K, C, neutral):
    out = jnp.full(_scatter_shape(K, C), neutral, x.dtype)
    return out.at[slot, cols].min(x)[:-1]


@functools.partial(
    jax.jit,
    static_argnames=("K", "min_duration", "join_gaps", "max_gap",
                     "intermediate", "day0_fillna_quirk"),
)
def detect_kernel(ts, th, se, doy_pos, K, min_duration=5, join_gaps=True,
                  max_gap=2, intermediate=False, day0_fillna_quirk=False):
    """Full detection pipeline for a (T, C) block: exceedance -> RLE ->
    gap joining -> per-event features.

    Parameters
    ----------
    ts: (T, C) float — SST per (time, cell)
    th, se: (D, C) float — doy climatologies; broadcast to the time axis by
        an on-device gather (th.sel(doy=ts.doy) in the reference,
        identify.py:367-368)
    doy_pos: (T,) int32 — row of th/se for each timestep
    K: static int — event-table capacity per cell

    Returns
    -------
    table: dict of (K, C) arrays — all per-event properties; NaN-padded
    n_events: (C,) int32 — RAW per-cell event count (may exceed K; the
        table only holds the first K events — callers use the excess to
        detect overflow and retry with a larger K)
    inter: dict of (T, C) per-day arrays (empty when intermediate=False)
    """
    T, C = ts.shape
    dt = ts.dtype
    nan = jnp.asarray(jnp.nan, dt)

    thresh_t = th[doy_pos]
    seas_t = se[doy_pos]
    bthresh = ts > thresh_t
    f = mhw_filter(bthresh, min_duration=min_duration, join_gaps=join_gaps,
                   max_gap=max_gap, day0_fillna_quirk=day0_fillna_quirk)
    day = f["event_day"]
    slot_raw = f["slot"]
    # raw count (may exceed K); rows beyond K land in the trash row
    n_events = f["n_events"]
    n_valid = jnp.minimum(n_events, K)

    idx = lax.broadcasted_iota(_I32, ts.shape, 0)
    cols = lax.broadcasted_iota(_I32, ts.shape, 1)
    slot = jnp.where(day & (slot_raw < K), slot_raw, K)  # K = trash row

    # ---- per-day derived columns (reference: features.py:44-68) ----------
    anom = ts - seas_t
    anom_plus = jnp.concatenate([jnp.full((1, C), nan), anom[:-1]], axis=0)
    anom_minus = jnp.concatenate([anom[1:], jnp.full((1, C), nan)], axis=0)
    relSeas = jnp.where(day, ts - seas_t, nan)
    relThresh = jnp.where(day, ts - thresh_t, nan)
    th_se = thresh_t - seas_t
    relThreshNorm = jnp.where(day, relThresh / th_se, nan)
    severity = jnp.where(day, relSeas / -th_se, nan)
    cats = jnp.floor(1.0 + relThreshNorm)
    mabs = jnp.where(day, ts, nan)
    dur_moderate = cats == 1.0
    dur_strong = cats == 2.0
    dur_severe = cats == 3.0
    dur_extreme = cats >= 4.0

    # ---- segment reductions ----------------------------------------------
    def ssum(x, finite):
        return _seg_sum(jnp.where(finite, x, 0.0).astype(dt), slot, cols, K,
                        C)

    def scnt(finite):
        return _seg_sum(finite.astype(dt), slot, cols, K, C)

    def smax(x, finite):
        neg = jnp.asarray(-jnp.inf, dt)
        return _seg_max(jnp.where(finite, x, neg), slot, cols, K, C, neg)

    fin_rs = jnp.isfinite(relSeas)
    fin_rt = jnp.isfinite(relThresh)
    fin_sv = jnp.isfinite(severity)
    fin_ma = jnp.isfinite(mabs)
    fin_ct = jnp.isfinite(cats)

    n_rs = scnt(fin_rs)
    n_rt = scnt(fin_rt)
    n_sv = scnt(fin_sv)
    n_ma = scnt(fin_ma)

    sum_rs = ssum(relSeas, fin_rs)
    sum_rt = ssum(relThresh, fin_rt)
    sum_sv = ssum(severity, fin_sv)
    sum_ma = ssum(mabs, fin_ma)

    max_rs = smax(relSeas, fin_rs)
    max_sv = smax(severity, fin_sv)
    max_ct = smax(cats, fin_ct)

    def _mean(s, n):
        return jnp.where(n > 0, s / jnp.maximum(n, 1.0), nan)

    mean_rs = _mean(sum_rs, n_rs)
    mean_rt = _mean(sum_rt, n_rt)
    mean_sv = _mean(sum_sv, n_sv)
    mean_ma = _mean(sum_ma, n_ma)

    # two-pass variance (ddof=1, pandas default — features.py:139-141,146)
    def _std(x, finite, mean, n):
        mean_day = mean[slot.clip(0, K - 1), cols]
        dev = jnp.where(finite, (x - mean_day) ** 2, 0.0).astype(dt)
        ss = _seg_sum(dev, slot, cols, K, C)
        var = jnp.where(n > 1, ss / jnp.maximum(n - 1.0, 1.0), nan)
        return jnp.sqrt(var)

    std_rs = _std(relSeas, fin_rs, mean_rs, n_rs)
    std_rt = _std(relThresh, fin_rt, mean_rt, n_rt)
    std_sv = _std(severity, fin_sv, mean_sv, n_sv)
    std_ma = _std(mabs, fin_ma, mean_ma, n_ma)

    # ---- positional reductions --------------------------------------------
    bigi = _I32(4 * T + 64)
    start = _seg_min(jnp.where(day, idx, bigi), slot, cols, K, C, bigi)
    end = _seg_max(jnp.where(day, idx, _I32(-1)), slot, cols, K, C,
                   _I32(-1))

    # peak: first day achieving the segment max of relSeas
    max_rs_day = max_rs[slot.clip(0, K - 1), cols]
    at_peak = day & fin_rs & (relSeas == max_rs_day)
    peak = _seg_min(jnp.where(at_peak, idx, bigi), slot, cols, K, C, bigi)

    # first/last finite positions (pandas 'first'/'last' skip NaN)
    def first_finite(finite):
        return _seg_min(jnp.where(day & finite, idx, bigi), slot, cols, K,
                        C, bigi)

    def last_finite(finite):
        return _seg_max(jnp.where(day & finite, idx, _I32(-1)), slot, cols,
                        K, C, _I32(-1))

    fin_ap = jnp.isfinite(anom_plus) & day
    fin_am = jnp.isfinite(anom_minus) & day
    i_rs_first = first_finite(fin_rs)
    i_rs_last = last_finite(fin_rs)
    i_ap_first = first_finite(fin_ap)
    i_am_last = last_finite(fin_am)

    valid = (lax.broadcasted_iota(_I32, (K, C), 0)
             < n_valid[None, :])

    def gather_day(x, pos, pos_valid):
        v = x[pos.clip(0, T - 1), lax.broadcasted_iota(_I32, (K, C), 1)]
        return jnp.where(valid & pos_valid, v, nan)

    relS_first = gather_day(relSeas, i_rs_first, i_rs_first < bigi)
    relS_last = gather_day(relSeas, i_rs_last, i_rs_last >= 0)
    anom_first = gather_day(anom_plus, i_ap_first, i_ap_first < bigi)
    anom_last = gather_day(anom_minus, i_am_last, i_am_last >= 0)
    int_max_relT = gather_day(relThresh, peak, peak < bigi)
    int_max_abs = gather_day(mabs, peak, peak < bigi)

    # ---- closed-form properties (reference: features.py:161-295) ----------
    startf = jnp.where(valid, start, 0).astype(dt)
    endf = jnp.where(valid, end, 0).astype(dt)
    peakf = jnp.where(valid, peak, 0).astype(dt)
    duration = endf - startf + 1.0
    category = jnp.minimum(max_ct, 4.0)

    tsend = jnp.asarray(T - 1, dt)
    rel_peak = peakf - startf
    # get_period (reference: features.py:225-263) — literal semantics,
    # including the rel_peak != tsend comparison quirk
    x = jnp.where(rel_peak != 0, rel_peak, 1.0)
    onset_period = jnp.where(startf == 0, x, x + 0.5)
    esp = endf - startf - rel_peak
    y = jnp.where(rel_peak != tsend, esp, 1.0)
    decline_period = jnp.where(endf == tsend, y, y + 0.5)

    # get_edge (reference: features.py:201-222)
    edge_onset = 0.5 * (relS_first
                        + jnp.where(startf == 0, relS_first, anom_first))
    edge_decline = 0.5 * (relS_last
                          + jnp.where(endf == tsend, relS_last, anom_last))
    rate_onset = (max_rs - edge_onset) / onset_period
    rate_decline = (max_rs - edge_decline) / decline_period

    def masked(v):
        return jnp.where(valid, v, nan)

    table = {
        "event": masked(startf),
        "index_start": masked(startf),
        "index_end": masked(endf),
        "time_start": jnp.where(valid, start, -1),
        "time_end": jnp.where(valid, end, -1),
        "time_peak": jnp.where(valid, peak, -1),
        "intensity_max": masked(max_rs),
        "intensity_mean": masked(mean_rs),
        "intensity_cumulative": masked(sum_rs),
        "severity_max": masked(max_sv),
        "severity_mean": masked(mean_sv),
        "severity_cumulative": masked(sum_sv),
        "severity_var": masked(std_sv),
        "intensity_mean_relThresh": masked(mean_rt),
        "intensity_cumulative_relThresh": masked(sum_rt),
        "intensity_mean_abs": masked(mean_ma),
        "intensity_cumulative_abs": masked(sum_ma),
        "duration_moderate": masked(ssum(dur_moderate.astype(dt), day)),
        "duration_strong": masked(ssum(dur_strong.astype(dt), day)),
        "duration_severe": masked(ssum(dur_severe.astype(dt), day)),
        "duration_extreme": masked(ssum(dur_extreme.astype(dt), day)),
        "index_peak": masked(peakf),
        "intensity_var": masked(std_rs),
        "intensity_max_relThresh": masked(int_max_relT),
        "intensity_max_abs": masked(int_max_abs),
        "intensity_var_relThresh": masked(std_rt),
        "intensity_var_abs": masked(std_ma),
        "category": masked(category),
        "duration": masked(duration),
        "rate_onset": masked(rate_onset),
        "rate_decline": masked(rate_decline),
    }

    inter = {}
    if intermediate:
        inter = {
            "ts": ts,
            "seas": jnp.where(day, seas_t, nan),
            "thresh": jnp.where(day, thresh_t, nan),
            "bthresh": bthresh,
            "events": jnp.where(day, f["event_id"].astype(dt), nan),
            "relSeas": relSeas,
            "relThresh": relThresh,
            "relThreshNorm": relThreshNorm,
            "severity": severity,
            "cats": cats,
            "duration_moderate": dur_moderate & day,
            "duration_strong": dur_strong & day,
            "duration_severe": dur_severe & day,
            "duration_extreme": dur_extreme & day,
            "mabs": mabs,
        }
    return table, n_events, inter
