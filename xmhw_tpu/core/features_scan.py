"""Scatter-free event feature engine: one fused segmented scan.

Alternative to :mod:`xmhw_tpu.core.features` (scatter-based segment
reductions) that needs no scatters and no sorts. It exploits the fact that
events are CONTIGUOUS runs along time (reference semantics: mhw_filter +
join_gaps produce contiguous spans, xmhw/identify.py:415-479):

* every per-event reduction rides ONE segmented associative scan that
  resets at each event start: the 17 sum/count channels, the running
  max / first-argmax, and the first/last finite positions. The scan state
  at an event's end row IS that event's result, so the table is read with
  (K, C) gathers at the end positions. Sums restart at every event, so a
  float32 total never carries the magnitude of the whole 40-year record
  (a prefix-sum difference does, and loses the small event variances);
* variances use the per-cell-shifted single-pass identity
  sum((x-mu)^2) = sum((x-a)^2) - n*(mu-a)^2 with a = per-cell mean, so
  values are centered before squaring;
* the event table is compacted by two-level counting on the cumulative
  start-count (monotone, already computed by mhw_filter); end positions
  ride the same block gather.

The public contract (outputs, NaN padding, reference formulas for
onset/decline, reference: xmhw/features.py:22-295) is identical to
features.detect_kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .events import mhw_filter

_I32 = jnp.int32

# detect_kernel's event-table variables (jit returns dict keys sorted);
# tests assert this stays in sync with the actual output
TABLE_VARS = (
    "category", "duration", "duration_extreme", "duration_moderate",
    "duration_severe", "duration_strong", "event", "index_end",
    "index_peak", "index_start", "intensity_cumulative",
    "intensity_cumulative_abs", "intensity_cumulative_relThresh",
    "intensity_max", "intensity_max_abs", "intensity_max_relThresh",
    "intensity_mean", "intensity_mean_abs", "intensity_mean_relThresh",
    "intensity_var", "intensity_var_abs", "intensity_var_relThresh",
    "rate_decline", "rate_onset", "severity_cumulative", "severity_max",
    "severity_mean", "severity_var", "time_end", "time_peak",
    "time_start",
)
# the rankable subset — mhw_rank skips event/time/index variables
# (reference: xmhw/stats.py:482-486)
RANK_VARS = tuple(k for k in TABLE_VARS
                  if not any(x in k for x in ("event", "time", "index")))


_TBK = 128  # rows per counting block of the two-level compaction


@functools.partial(
    jax.jit,
    static_argnames=("K", "min_duration", "join_gaps", "max_gap",
                     "intermediate", "day0_fillna_quirk"),
)
def detect_kernel(ts, th, se, doy_pos, K, min_duration=5, join_gaps=True,
                  max_gap=2, intermediate=False, day0_fillna_quirk=False):
    """Scan-based detection pipeline; same contract as
    features.detect_kernel (see that docstring for parameters)."""
    T, C = ts.shape
    dt = ts.dtype
    nan = jnp.asarray(jnp.nan, dt)
    neg = jnp.asarray(-jnp.inf, dt)
    bigi = _I32(4 * T + 64)

    thresh_t = th[doy_pos]
    seas_t = se[doy_pos]
    bthresh = ts > thresh_t
    f = mhw_filter(bthresh, min_duration=min_duration, join_gaps=join_gaps,
                   max_gap=max_gap, day0_fillna_quirk=day0_fillna_quirk)
    day = f["event_day"]
    is_start = f["is_start"]
    # raw per-cell count (may exceed K — callers detect table overflow
    # from it and retry with a larger K); rows beyond K are not emitted
    n_events = f["n_events"]
    n_valid = jnp.minimum(n_events, K)

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

    fin_rs = jnp.isfinite(relSeas)
    fin_rt = jnp.isfinite(relThresh)
    fin_sv = jnp.isfinite(severity)
    fin_ma = jnp.isfinite(mabs)
    fin_ct = jnp.isfinite(cats)
    fin_ap = jnp.isfinite(anom_plus) & day
    fin_am = jnp.isfinite(anom_minus) & day

    # ---- compaction geometry: two-level counting, no sort, no scatters ----
    # cumstart = slot+1 = cumsum(is_start) is monotone along time (already
    # computed by mhw_filter), so the start day of event k is the first t
    # with cumstart >= k+1. Count at two levels: (1) block-final samples
    # (nbk, C) locate the _TBK-row block by a broadcast compare+sum, (2)
    # ONE gather pulls each event's block and a second compare+sum finds
    # the offset within it. The event's end rides the same gather: the
    # start row of event k is a day row, so ev_end there is its end.
    cumstart = f["slot"] + 1  # (T, C) monotone
    target = (lax.broadcasted_iota(_I32, (K, C), 0) + 1)  # k+1 per row
    nbk = -(-T // _TBK)
    valid = (lax.broadcasted_iota(_I32, (K, C), 0) < n_valid[None, :])
    evd = jnp.where(day, f["ev_end"], 0)

    def blockify(x):  # (T, C) -> (nbk, C, _TBK)
        if nbk * _TBK != T:  # pad rows repeat the final row (the counter
            # never drops below target; pad ev_end rows are only read for
            # invalid, masked events)
            x = jnp.concatenate(
                [x, jnp.broadcast_to(x[-1:], (nbk * _TBK - T, C))], axis=0)
        return x.reshape(nbk, _TBK, C).transpose(0, 2, 1)

    cb = blockify(cumstart)
    blocks_t = jnp.concatenate([cb, blockify(evd)], axis=2)  # (nbk,C,2TBK)
    blk_final = cb[:, :, _TBK - 1]  # (nbk, C)
    bk = jnp.sum((blk_final[:, None, :] < target[None, :, :])
                 .astype(_I32), axis=0,
                 dtype=_I32)  # (K, C) block holding event k
    blk_t = jnp.take_along_axis(
        blocks_t, jnp.clip(bk, 0, nbk - 1)[:, :, None],
        axis=0)  # (K, C, 2*_TBK)
    within = jnp.sum((blk_t[:, :, :_TBK] < target[:, :, None])
                     .astype(_I32), axis=2, dtype=_I32)
    start_pos = jnp.minimum(bk * _TBK + within, T - 1)
    start = jnp.where(valid, start_pos, 0)
    woff = jnp.clip(within, 0, _TBK - 1)[:, :, None]
    end_pos = jnp.sum(
        jnp.where(
            lax.broadcasted_iota(_I32, (K, C, _TBK), 2) == woff,
            blk_t[:, :, _TBK:], 0), axis=2,
        dtype=_I32)  # pin: x64 would promote to int64
    end_pos = jnp.clip(end_pos, 0, T - 1)
    end = jnp.where(valid, end_pos, 0)

    def at(x, pos):
        return jnp.take_along_axis(x, pos, axis=0)

    # ---- ONE fused segmented scan, reset at every event start ------------
    # Off-event days contribute each channel's neutral element, so the
    # state at an event's end row holds exactly that event's reductions.
    # The four moment groups (relSeas, relThresh, severity, absolute)
    # carry (count, mean, M2) and merge with Chan et al.'s pairwise
    # update, which never subtracts two large sums. Channels are stacked
    # into three arrays so each scan level is a handful of fused ops.
    fins = (fin_rs, fin_rt, fin_sv, fin_ma)
    vals = (relSeas, relThresh, severity, mabs)
    F = jnp.stack(
        [f.astype(dt) for f in fins]                          # 0-3 n
        + [jnp.where(f, v, 0) for f, v in zip(fins, vals)]    # 4-7 mean
        + [jnp.zeros_like(ts)] * 4                            # 8-11 M2
        + [(day & c).astype(dt) for c in (dur_moderate, dur_strong,
                                          dur_severe, dur_extreme)]
        + [(fin_ct & day).astype(dt),                         # 16
           jnp.where(day & fin_rs, relSeas, neg),             # 17 max
           jnp.where(day & fin_sv, severity, neg),            # 18 max
           jnp.where(day & fin_ct, cats, neg)],               # 19 max
        axis=1)  # (T, 20, C)
    idx = lax.broadcasted_iota(_I32, ts.shape, 0)
    I = jnp.stack([
        idx,                                     # first argmax of ch 17
        jnp.where(day & fin_rs, idx, bigi),      # first finite relSeas
        jnp.where(day & fin_rs, idx, _I32(-1)),  # last finite relSeas
        jnp.where(fin_ap, idx, bigi),            # first finite anom+
        jnp.where(fin_am, idx, _I32(-1)),        # last finite anom-
    ], axis=1)  # (T, 5, C)

    def comb(a, b):
        aF, aI, ar = a
        bF, bI, br = b
        na, nb = aF[:, 0:4], bF[:, 0:4]
        n = na + nb
        d = bF[:, 4:8] - aF[:, 4:8]
        w = nb / jnp.maximum(n, 1.0)
        take_b = br[:, 0] | (bF[:, 17] > aF[:, 17])
        Fm = jnp.concatenate([
            n, aF[:, 4:8] + d * w,
            aF[:, 8:12] + bF[:, 8:12] + d * d * na * w,
            aF[:, 12:17] + bF[:, 12:17],
            jnp.where(take_b, bF[:, 17], aF[:, 17])[:, None],
            jnp.maximum(aF[:, 18:20], bF[:, 18:20])], axis=1)
        Im = jnp.concatenate([
            jnp.where(take_b, bI[:, 0], aI[:, 0])[:, None],
            jnp.minimum(aI[:, 1:2], bI[:, 1:2]),
            jnp.maximum(aI[:, 2:3], bI[:, 2:3]),
            jnp.minimum(aI[:, 3:4], bI[:, 3:4]),
            jnp.maximum(aI[:, 4:5], bI[:, 4:5])], axis=1)
        return (jnp.where(br, bF, Fm), jnp.where(br, bI, Im), ar | br)

    Fs, Is, _ = lax.associative_scan(comb, (F, I, is_start[:, None, :]),
                                     axis=0)
    ends = end_pos[:, None, :]
    Fe = jnp.take_along_axis(Fs, ends, axis=0)  # (K, 20, C)
    Ie = jnp.take_along_axis(Is, ends, axis=0)  # (K, 5, C)
    e_max_rs, e_max_sv, e_max_ct = Fe[:, 17], Fe[:, 18], Fe[:, 19]
    peak, i_rs_first, i_rs_last, i_ap_first, i_am_last = (
        Ie[:, i] for i in range(5))

    def stats_from(g):
        n, mean, m2 = Fe[:, g], Fe[:, 4 + g], Fe[:, 8 + g]
        std = jnp.sqrt(jnp.maximum(m2, 0.0) / jnp.maximum(n - 1.0, 1.0))
        return (n, jnp.where(n > 0, n * mean, nan),
                jnp.where(n > 0, mean, nan), jnp.where(n > 1, std, nan))

    n_rs, sum_rs, mean_rs, std_rs = stats_from(0)
    n_rt, sum_rt, mean_rt, std_rt = stats_from(1)
    n_sv, sum_sv, mean_sv, std_sv = stats_from(2)
    n_ma, sum_ma, mean_ma, std_ma = stats_from(3)
    dur_mod, dur_str, dur_sev, dur_ext = (Fe[:, i] for i in range(12, 16))
    n_ct = Fe[:, 16]

    max_rs = jnp.where(valid & (n_rs > 0), e_max_rs, nan)
    max_sv = jnp.where(valid & (n_sv > 0), e_max_sv, nan)
    max_ct = jnp.where(valid & (n_ct > 0), e_max_ct, nan)

    def _val(x, pos, ok):
        return jnp.where(valid & ok, at(x, jnp.clip(pos, 0, T - 1)), nan)

    relS_first = _val(relSeas, i_rs_first, i_rs_first < bigi)
    relS_last = _val(relSeas, i_rs_last, i_rs_last >= 0)
    anom_first = _val(anom_plus, i_ap_first, i_ap_first < bigi)
    anom_last = _val(anom_minus, i_am_last, i_am_last >= 0)
    int_max_relT = _val(relThresh, peak, n_rs > 0)
    int_max_abs = _val(mabs, peak, n_rs > 0)

    # ---- closed-form properties (reference: features.py:161-295) ----------
    startf = jnp.where(valid, start, 0).astype(dt)
    endf = jnp.where(valid, end, 0).astype(dt)
    peakf = jnp.where(valid & (n_rs > 0), peak, 0).astype(dt)
    duration = endf - startf + 1.0
    category = jnp.minimum(max_ct, 4.0)

    tsend = jnp.asarray(T - 1, dt)
    rel_peak = peakf - startf
    x = jnp.where(rel_peak != 0, rel_peak, 1.0)
    onset_period = jnp.where(startf == 0, x, x + 0.5)
    esp = endf - startf - rel_peak
    y = jnp.where(rel_peak != tsend, esp, 1.0)
    decline_period = jnp.where(endf == tsend, y, y + 0.5)

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
        "time_peak": jnp.where(valid & (n_rs > 0), peak, -1),
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
        "duration_moderate": masked(dur_mod),
        "duration_strong": masked(dur_str),
        "duration_severe": masked(dur_sev),
        "duration_extreme": masked(dur_ext),
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
