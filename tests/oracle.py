"""Deliberately-naive numpy oracle of the Hobday et al. (2016) pipeline.

Implements the reference semantics (windowed doy climatology, RLE event
detection with maxGap joining, per-event properties) with obvious Python
loops — no vectorization tricks shared with the framework — so that
agreement between the two is strong evidence of correctness.

Semantics follow the reference implementation:
* pooling: for every timestep t and offset |k| <= w, value ts[t+k] joins
  the bucket of doy[t]; NaNs dropped (xmhw/identify.py:184-209, 208)
* quantile: numpy linear interpolation (identify.py:233-235)
* feb29: mean of doys 59..61 (identify.py:137-151)
* smoothing: circular running mean (identify.py:154-181)
* events: runs >= minDuration; gaps <= maxGap between kept events merge
  transitively, gap days included (identify.py:273-479)
* properties: pandas-aggregation semantics (features.py:22-295)
"""

from __future__ import annotations

import numpy as np


def clim_oracle(ts, doy, ndoy, w=5, pctile=90, smooth=True, smooth_w=31,
                feb29=True):
    """ts: (T,) float; returns (thresh, seas) each (ndoy,)."""
    T = len(ts)
    pools = [[] for _ in range(ndoy)]
    for t in range(T):
        d = doy[t] - 1
        for k in range(-w, w + 1):
            if 0 <= t + k < T:
                v = ts[t + k]
                if np.isfinite(v):
                    pools[d].append(v)
    th = np.full(ndoy, np.nan)
    se = np.full(ndoy, np.nan)
    for d in range(ndoy):
        if pools[d]:
            th[d] = np.quantile(np.asarray(pools[d], np.float64),
                                pctile / 100)
            se[d] = np.mean(pools[d])
    if feb29:
        th[59] = np.nanmean(th[58:61])
        se[59] = np.nanmean(se[58:61])
    if smooth:
        th = _circ_smooth(th, smooth_w)
        se = _circ_smooth(se, smooth_w)
    return th, se


def _circ_smooth(x, w):
    n = len(x)
    half = (w - 1) // 2
    out = np.empty(n)
    for i in range(n):
        vals = [x[(i + k) % n] for k in range(-half, half + 1)]
        out[i] = np.mean(vals)  # NaN-propagating like the reference
    return out


def events_oracle(ts, th_t, se_t, min_duration=5, join_gaps=True,
                  max_gap=2):
    """Detect merged events in a 1-D series; returns list of dicts with
    the full reference property set."""
    T = len(ts)
    b = np.zeros(T, bool)
    for t in range(T):
        b[t] = (np.isfinite(ts[t]) and np.isfinite(th_t[t])
                and ts[t] > th_t[t])
    # runs of True
    runs = []
    t = 0
    while t < T:
        if b[t]:
            s = t
            while t + 1 < T and b[t + 1]:
                t += 1
            runs.append((s, t))
        t += 1
    kept = [(s, e) for s, e in runs if e - s + 1 >= min_duration]
    if join_gaps:
        merged = []
        for s, e in kept:
            if merged and s - merged[-1][1] - 1 <= max_gap:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
    else:
        merged = kept

    anom = ts - se_t
    events = []
    for s, e in merged:
        days = np.arange(s, e + 1)
        relS = ts[days] - se_t[days]
        relT = ts[days] - th_t[days]
        th_se = th_t[days] - se_t[days]
        relTN = relT / th_se
        sev = relS / -th_se
        cats = np.floor(1.0 + relTN)
        mabs = ts[days]

        def nmean(x):
            return np.nanmean(x) if np.isfinite(x).any() else np.nan

        def nsum(x):
            return np.nansum(x) if np.isfinite(x).any() else np.nan

        def nstd(x):
            x = x[np.isfinite(x)]
            return np.std(x, ddof=1) if len(x) > 1 else np.nan

        ipk = int(days[np.nanargmax(relS)]) if np.isfinite(relS).any() \
            else s
        rel_peak = ipk - s
        imax = np.nanmax(relS)
        # onset/decline (reference: features.py:196-295)
        anom_plus = anom[s - 1] if s >= 1 else np.nan
        # pandas 'first' skips NaN within the event's shifted series
        if not np.isfinite(anom_plus):
            for t2 in range(s, e):  # anom_plus[t] = anom[t-1]
                if np.isfinite(anom[t2]):
                    anom_plus = anom[t2]
                    break
        anom_minus = anom[e + 1] if e + 1 < T else np.nan
        if not np.isfinite(anom_minus):
            for t2 in range(e - 1, s - 1, -1):  # anom_minus[t]=anom[t+1]
                if np.isfinite(anom[t2 + 1] if t2 + 1 <= e else np.nan):
                    anom_minus = anom[t2 + 1]
                    break
        relS_first = relS[np.isfinite(relS)][0] if np.isfinite(relS).any()\
            else np.nan
        relS_last = relS[np.isfinite(relS)][-1] if np.isfinite(relS).any()\
            else np.nan
        x = rel_peak if rel_peak != 0 else 1.0
        onset_period = x if s == 0 else x + 0.5
        esp = e - s - rel_peak
        y = esp if rel_peak != T - 1 else 1.0
        decline_period = y if e == T - 1 else y + 0.5
        edge_on = 0.5 * (relS_first + (relS_first if s == 0 else anom_plus))
        edge_de = 0.5 * (relS_last + (relS_last if e == T - 1
                                      else anom_minus))
        events.append({
            "event": float(s),
            "index_start": float(s),
            "index_end": float(e),
            "index_peak": float(ipk),
            "duration": float(e - s + 1),
            "intensity_max": imax,
            "intensity_mean": nmean(relS),
            "intensity_cumulative": nsum(relS),
            "intensity_var": nstd(relS),
            "severity_max": np.nanmax(sev),
            "severity_mean": nmean(sev),
            "severity_cumulative": nsum(sev),
            "severity_var": nstd(sev),
            "intensity_mean_relThresh": nmean(relT),
            "intensity_cumulative_relThresh": nsum(relT),
            "intensity_var_relThresh": nstd(relT),
            "intensity_max_relThresh": relT[np.nanargmax(relS)],
            "intensity_mean_abs": nmean(mabs),
            "intensity_cumulative_abs": nsum(mabs),
            "intensity_var_abs": nstd(mabs),
            "intensity_max_abs": mabs[np.nanargmax(relS)],
            "category": min(np.nanmax(cats), 4.0),
            "duration_moderate": float((cats == 1).sum()),
            "duration_strong": float((cats == 2).sum()),
            "duration_severe": float((cats == 3).sum()),
            "duration_extreme": float((cats >= 4).sum()),
            "rate_onset": (imax - edge_on) / onset_period,
            "rate_decline": (imax - edge_de) / decline_period,
        })
    return events


# ---- float32 engine vs this float64 oracle -------------------------------
# Both sides see the same float32 series and climatology. Counts, indexes,
# durations and categories are exact. Sums, means, maxima and rates round
# at ~1e-7 relative in float32; 1e-5 leaves margin. Standard deviations
# of an event's values carry the float32 quantisation of the inputs
# (~1e-6 degC on a ~20 degC absolute temperature) relative to a spread
# that can be ~0.05 degC, hence 1e-4. A prefix-sum (not segmented) engine
# misses these by orders of magnitude at T=14610.
F32_EVENT_ATOL = 1e-5
_EXACT = ("event", "index_start", "index_end", "index_peak", "duration",
          "duration_moderate", "duration_strong", "duration_severe",
          "duration_extreme", "category")


def f32_event_rtol(prop):
    """Relative tolerance of one event property (None: must be exact)."""
    if prop in _EXACT:
        return None
    return 1e-4 if prop.endswith("_var") else 1e-5


def compare_events(col, evs, where=""):
    """Check one cell's float32 event table against oracle events.

    ``col``: {property: (K,) values} in event-slot order (NaN/-1 padded),
    including ``time_start``/``time_end``/``time_peak`` as time indexes;
    ``evs``: events_oracle's list. Returns the number of events checked.
    """
    n = int(np.isfinite(np.asarray(col["event"], np.float64)).sum())
    assert n == len(evs), f"{where}: {n} events vs oracle {len(evs)}"
    for k, ev in enumerate(evs):
        for tname, iname in (("time_start", "index_start"),
                             ("time_end", "index_end"),
                             ("time_peak", "index_peak")):
            assert int(col[tname][k]) == int(ev[iname]), (where, k, tname)
        for prop, want in ev.items():
            got = float(col[prop][k])
            rtol = f32_event_rtol(prop)
            if np.isnan(want):
                assert np.isnan(got), (where, k, prop, got)
            elif rtol is None:
                assert got == want, (where, k, prop, got, want)
            else:
                assert abs(got - want) <= F32_EVENT_ATOL + rtol * abs(
                    want), (where, k, prop, got, want)
    return len(evs)
