"""Host (numpy) engine for single-point workloads.

One cell is orders of magnitude below an accelerator's launch floor,
and the device programs pay whole-program compiles per fresh process
(10-25 s of LLVM compilation on XLA:CPU for a 30-year point). The
reference keeps a dedicated pandas point mode for exactly this reason
(reference: xmhw/xmhw.py:122-126); this module is its numpy equivalent —
zero compilation, milliseconds of compute, same contract as the device
engines (run_clim / run_detect in core.pipeline), so the API layer can
swap it in transparently for 1-D inputs.

Semantics mirror the device engines exactly and are asserted against
them by the differential tests (point-vs-grid in tests/test_api.py, the
dedicated matrix in tests/test_point_host.py, and the independent naive
oracle in tests/oracle.py):

* climatology pooling, quantile, feb29 patch and circular smoothing as
  core/clim.py (reference: identify.py:137-240);
* event RLE, minDuration filter, transitive gap joining and the
  day0_fillna quirk as core/events.mhw_filter (reference:
  identify.py:273-479);
* the full ~31-column event property table as
  core/features_scan.detect_kernel (reference: features.py:22-295),
  including the boundary half-day rules and the ``rel_peak != T-1``
  quirk of the onset/decline rates.

Math runs in float64 and is cast to the caller's dtype on return (the
f64 parity tests compare bit-for-bit against the device f64 path; for
f32 requests the extra intermediate precision is strictly better).
"""

from __future__ import annotations

import numpy as np

__all__ = ["point_clim", "point_detect", "point_interpolate_na",
           "runavg_circular_np"]


def runavg_circular_np(x, w):
    """Periodic centered running mean over axis 0 (NaN-propagating) —
    host twin of core.clim.runavg_circular (reference:
    identify.py:154-181)."""
    half = (w - 1) // 2
    xp = np.concatenate([x[-half:], x, x[:half]], axis=0)
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(xp, w, axis=0)
    return win.mean(axis=-1)


def _feb29_patch_np(clim):
    """Row 59 (doy 60) <- nanmean of rows 58..60 (doys 59..61); host twin
    of core.clim.feb29_patch (reference: identify.py:137-151)."""
    rows = clim[58:61]
    m = np.isfinite(rows)
    c = m.sum(axis=0)
    s = np.where(m, rows, 0.0).sum(axis=0)
    clim[59] = np.where(c > 0, s / np.maximum(c, 1), np.nan)
    return clim


def point_clim(data, doy, w, ndoy, pctile, smooth, smooth_w,
               patch_feb29):
    """Windowed doy percentile/mean climatology for one cell.

    Same contract as core.pipeline.run_clim: ``data`` (T, 1) ->
    (thresh, seas) each (ndoy, 1) in ``data.dtype``.
    """
    out_dt = data.dtype
    x = np.asarray(data[:, 0], np.float64)
    T = x.shape[0]
    # pooling: for every timestep t and offset |k| <= w, ts[t+k] joins
    # the bucket of doy[t] (reference: identify.py:184-209; NaNs never
    # enter the pool)
    labs, vals = [], []
    for k in range(-w, w + 1):
        lo, hi = max(0, -k), min(T, T - k)
        labs.append(doy[lo:hi])
        vals.append(x[lo + k:hi + k])
    lab = np.concatenate(labs).astype(np.int64) - 1
    v = np.concatenate(vals)
    fin = np.isfinite(v)
    lab, v = lab[fin], v[fin]
    order = np.argsort(lab, kind="stable")
    lab, v = lab[order], v[order]
    bounds = np.searchsorted(lab, np.arange(ndoy + 1))
    th = np.full(ndoy, np.nan)
    se = np.full(ndoy, np.nan)
    q = pctile / 100.0
    for d in range(ndoy):
        seg = v[bounds[d]:bounds[d + 1]]
        if seg.size:
            th[d] = np.quantile(seg, q)  # linear, = device rank math
            se[d] = seg.mean()
    if patch_feb29:
        th = _feb29_patch_np(th[:, None])[:, 0]
        se = _feb29_patch_np(se[:, None])[:, 0]
    if smooth:
        th = runavg_circular_np(th[:, None], smooth_w)[:, 0]
        se = runavg_circular_np(se[:, None], smooth_w)[:, 0]
    return th[:, None].astype(out_dt), se[:, None].astype(out_dt)


def _merged_events(b, min_duration, join_gaps, max_gap,
                   day0_fillna_quirk):
    """Qualifying (possibly gap-joined) events of a 1-D exceedance mask.

    Host twin of core.events.mhw_filter (reference: identify.py:273-479
    incl. the fillna(0) day-0 artifact behind ``day0_fillna_quirk``).
    Returns a list of (start, end) inclusive index pairs.
    """
    T = b.shape[0]
    d = np.diff(b.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1)
    if b[0]:
        starts = np.concatenate([[0], starts])
    if b[-1]:
        ends = np.concatenate([ends, [T - 1]])
    kept = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        n = e - s + 1
        if day0_fillna_quirk and s == 0:
            # reference artifact: a run touching day 0 loses its first
            # day (start -> 1, length -> n-1)
            s, n = 1, n - 1
        if n >= min_duration:
            kept.append((s, e))
    if not join_gaps:
        return kept
    merged = []
    for s, e in kept:
        if merged and s - merged[-1][1] - 1 <= max_gap:
            merged[-1] = (merged[-1][0], e)  # transitive, gap days join
        else:
            merged.append((s, e))
    return merged


def _nstd(vals):
    """ddof=1 std over finite values; NaN when fewer than 2."""
    f = vals[np.isfinite(vals)]
    return np.std(f, ddof=1) if f.size > 1 else np.nan


def _first_finite(vals):
    f = np.flatnonzero(np.isfinite(vals))
    return (int(f[0]), vals[f[0]]) if f.size else (None, np.nan)


def _last_finite(vals):
    f = np.flatnonzero(np.isfinite(vals))
    return (int(f[-1]), vals[f[-1]]) if f.size else (None, np.nan)


def point_detect(data, th, se, doy_pos, min_duration=5, join_gaps=True,
                 max_gap=2, intermediate=False, day0_fillna_quirk=False):
    """Detection + full event-property table for one cell.

    Same contract as core.pipeline.run_detect: ``data`` (T, 1), ``th``/
    ``se`` (D, 1) doy climatologies, ``doy_pos`` (T,) row map; returns
    (tables dict of (K, 1) numpy, n_events (1,) int32, inter dict of
    (T, 1)). Column set, dtypes, fill values and quirk semantics match
    core.features_scan.detect_kernel (reference: features.py:22-295).
    """
    dt = data.dtype
    x = np.asarray(data[:, 0], np.float64)
    T = x.shape[0]
    tht = np.asarray(th, np.float64)[doy_pos, 0]
    set_ = np.asarray(se, np.float64)[doy_pos, 0]

    with np.errstate(invalid="ignore", divide="ignore"):
        b = x > tht  # NaN compares False, like pandas
        events = _merged_events(b, min_duration, join_gaps, max_gap,
                                day0_fillna_quirk)
        nev = len(events)
        K = max(nev, 1)

        # per-day derived series on event days (reference:
        # features.py:44-68)
        day = np.zeros(T, bool)
        event_id = np.full(T, -1, np.int64)
        for s, e in events:
            day[s:e + 1] = True
            event_id[s:e + 1] = s
        anom = x - set_
        anom_plus = np.concatenate([[np.nan], anom[:-1]])   # anom[t-1]
        anom_minus = np.concatenate([anom[1:], [np.nan]])   # anom[t+1]
        relSeas = np.where(day, x - set_, np.nan)
        relThresh = np.where(day, x - tht, np.nan)
        th_se = tht - set_
        relThreshNorm = np.where(day, relThresh / th_se, np.nan)
        severity = np.where(day, relSeas / -th_se, np.nan)
        cats = np.floor(1.0 + relThreshNorm)
        mabs = np.where(day, x, np.nan)

        cols = {}

        def col(name, fill=np.nan, dtype=None):
            c = np.full((K, 1), fill, dtype or dt)
            cols[name] = c
            return c[:, 0]

        ev = col("event")
        i_start = col("index_start")
        i_end = col("index_end")
        t_start = col("time_start", -1, np.int32)
        t_end = col("time_end", -1, np.int32)
        t_peak = col("time_peak", -1, np.int32)
        imax = col("intensity_max")
        imean = col("intensity_mean")
        icum = col("intensity_cumulative")
        smax = col("severity_max")
        smean = col("severity_mean")
        scum = col("severity_cumulative")
        svar = col("severity_var")
        imean_rt = col("intensity_mean_relThresh")
        icum_rt = col("intensity_cumulative_relThresh")
        imean_ab = col("intensity_mean_abs")
        icum_ab = col("intensity_cumulative_abs")
        d_mod = col("duration_moderate")
        d_str = col("duration_strong")
        d_sev = col("duration_severe")
        d_ext = col("duration_extreme")
        i_peak = col("index_peak")
        ivar = col("intensity_var")
        imax_rt = col("intensity_max_relThresh")
        imax_ab = col("intensity_max_abs")
        ivar_rt = col("intensity_var_relThresh")
        ivar_ab = col("intensity_var_abs")
        cat = col("category")
        dur = col("duration")
        r_on = col("rate_onset")
        r_de = col("rate_decline")

        for k, (s, e) in enumerate(events):
            sl = slice(s, e + 1)
            rs, rt, sv, ct, ma = (relSeas[sl], relThresh[sl],
                                  severity[sl], cats[sl], mabs[sl])
            fin_rs = np.isfinite(rs)
            n_rs = int(fin_rs.sum())

            ev[k] = i_start[k] = s
            i_end[k] = e
            t_start[k], t_end[k] = s, e
            dur[k] = e - s + 1

            # stats blocks (nanmean/nansum, NaN on empty; ddof=1 std)
            def stats(vals, mean_c, cum_c, var_c=None, max_c=None):
                f = vals[np.isfinite(vals)]
                if f.size:
                    mean_c[k] = f.mean()
                    cum_c[k] = f.sum()
                if var_c is not None:
                    var_c[k] = _nstd(vals)
                if max_c is not None and f.size:
                    max_c[k] = f.max()

            stats(rs, imean, icum, ivar)
            stats(rt, imean_rt, icum_rt, ivar_rt)
            stats(sv, smean, scum, svar, smax)
            stats(ma, imean_ab, icum_ab, ivar_ab)

            fc = ct[np.isfinite(ct)]
            if fc.size:
                cat[k] = min(fc.max(), 4.0)
            d_mod[k] = (ct == 1.0).sum()
            d_str[k] = (ct == 2.0).sum()
            d_sev[k] = (ct == 3.0).sum()
            d_ext[k] = np.nansum(ct >= 4.0)

            if n_rs:
                pk = s + int(np.nanargmax(rs))  # first argmax
                t_peak[k] = pk
                i_peak[k] = pk
                imax[k] = relSeas[pk]
                imax_rt[k] = relThresh[pk]
                imax_ab[k] = mabs[pk]
            else:  # degenerate (never on a real event); kernel uses 0
                pk = 0
                i_peak[k] = 0.0

            # onset/decline rates (reference: features.py:196-295 incl.
            # the `rel_peak != T-1` comparison quirk)
            _, relS_first = _first_finite(rs)
            _, relS_last = _last_finite(rs)
            ap = np.where(np.isfinite(anom_plus[sl]), anom_plus[sl],
                          np.nan)
            am = np.where(np.isfinite(anom_minus[sl]), anom_minus[sl],
                          np.nan)
            _, anom_first = _first_finite(ap)
            _, anom_last = _last_finite(am)
            tsend = T - 1
            rel_peak = pk - s
            xo = rel_peak if rel_peak != 0 else 1.0
            onset_period = xo if s == 0 else xo + 0.5
            esp = e - s - rel_peak
            yo = esp if rel_peak != tsend else 1.0
            decline_period = yo if e == tsend else yo + 0.5
            edge_on = 0.5 * (relS_first + (relS_first if s == 0
                                           else anom_first))
            edge_de = 0.5 * (relS_last + (relS_last if e == tsend
                                          else anom_last))
            r_on[k] = (imax[k] - edge_on) / onset_period
            r_de[k] = (imax[k] - edge_de) / decline_period

        inter = {}
        if intermediate:
            nan = np.nan
            inter = {
                "ts": x.astype(dt),
                "seas": np.where(day, set_, nan).astype(dt),
                "thresh": np.where(day, tht, nan).astype(dt),
                "bthresh": b,
                "events": np.where(day, event_id.astype(np.float64),
                                   nan).astype(dt),
                "relSeas": relSeas.astype(dt),
                "relThresh": relThresh.astype(dt),
                "relThreshNorm": relThreshNorm.astype(dt),
                "severity": severity.astype(dt),
                "cats": cats.astype(dt),
                "duration_moderate": (cats == 1.0) & day,
                "duration_strong": (cats == 2.0) & day,
                "duration_severe": (cats == 3.0) & day,
                "duration_extreme": np.where(np.isfinite(cats),
                                             cats >= 4.0, False) & day,
                "mabs": mabs.astype(dt),
            }
            inter = {kk: vv[:, None] for kk, vv in inter.items()}

    return cols, np.asarray([nev], np.int32), inter


def point_interpolate_na(data, max_gap=None):
    """Linear interpolation of interior NaN runs (host twin of
    core.events.interpolate_na_device; reference: xmhw.py:159-160).
    Runs strictly between valid samples are filled; runs longer than
    ``max_gap`` (if given) stay NaN."""
    out = np.array(data, copy=True)
    for c in range(out.shape[1]):
        x = out[:, c]
        good = np.isfinite(x)
        if good.all() or not good.any():
            continue
        T = x.shape[0]
        idx = np.arange(T)
        prev_i = np.maximum.accumulate(np.where(good, idx, -1))
        next_i = np.minimum.accumulate(np.where(good, idx, T)[::-1])[::-1]
        fillable = ~good & (prev_i >= 0) & (next_i < T)
        if max_gap is not None:
            fillable &= (next_i - prev_i - 1) <= max_gap
        pv = x[np.clip(prev_i, 0, T - 1)]
        nv = x[np.clip(next_i, 0, T - 1)]
        span = np.maximum(next_i - prev_i, 1)
        interp = pv + (idx - prev_i) / span * (nv - pv)
        x[fillable] = interp[fillable]
    return out
