"""Public API: threshold() and detect() with reference-compatible surface.

Signatures, parameter names, defaults, validation errors, output variables
and attributes match the reference (threshold: xmhw/xmhw.py:38-51,
detect: xmhw/xmhw.py:310-323). The mechanism is entirely different:
instead of a per-cell dask.delayed graph over xarray/pandas objects, all
cells are processed as dense (time, cell) JAX arrays in jit-compiled
blocks, optionally sharded over a device mesh (see xmhw_tpu.core.pipeline).
"""

from __future__ import annotations

import os

import numpy as np

from .annotate import annotate_ds, detect_params_attr, threshold_params_attr
from .core.calendar import compute_doy, get_calendar
from .core.pipeline import run_clim, run_detect
from .core.point import (point_clim, point_detect, point_interpolate_na,
                         runavg_circular_np as _runavg_circular_np)
from .exception import XmhwException
from .xrlite import Coord, DataArray, Dataset, TimeIndex, unstack_cell
from .xrlite.adapt import as_dataarray

__all__ = ["threshold", "detect", "land_check"]


def land_check(temp, tdim="time", anynans=False):
    """Stack all non-time dims into 'cell' and drop land (NaN) cells.

    Reference: xmhw/identify.py:482-529. Raises on time-only input, on a
    zero-length dim, and when every cell is land.
    """
    temp = as_dataarray(temp)
    dims = [d for d in temp.dims if d != tdim]
    if tdim not in temp.dims:
        raise XmhwException(f"{tdim} dimension not present")
    if len(dims) == 0:
        raise XmhwException(
            "Series has only time dimension use point=True option, exiting")
    for d in dims:
        if temp.sizes[d] == 0:
            raise XmhwException(f"Dimension {d} has 0 lenght, exiting")
    ts = temp.stack_cell(dims, "cell")
    # drop cells that are all-NaN (or any-NaN) along the time axis
    data = ts.data
    tax = ts.dims.index(tdim)
    nan = np.isnan(data)
    drop = nan.all(axis=tax) if not anynans else nan.any(axis=tax)
    keep = np.nonzero(~drop)[0]
    if keep.size == 0:
        raise XmhwException("All points of grid are either land or NaN")
    return ts.isel(cell=keep)


def _use_point_host() -> bool:
    """Single-point workloads run on the HOST numpy engine
    (core/point.py): one cell is far below an accelerator's launch
    floor, and the device path pays whole-program compiles (10-25 s of
    XLA:CPU LLVM work for a 30-yr point) vs milliseconds of numpy. The
    reference keeps a dedicated pandas point mode for the same reason
    (reference: xmhw/xmhw.py:122-126). Set
    XMHW_POINT_HOST=0 to force points through the device engines."""
    return os.environ.get("XMHW_POINT_HOST", "1") != "0"


def _interpolate_na(data, max_gap):
    """Vectorized interior-NaN filling on device (maxPadLength,
    reference: xmhw.py:159-160) — the labeled-array method loops cells in
    Python and would be minutes at planet scale."""
    import jax.numpy as jnp

    from .core.events import interpolate_na_device

    return np.asarray(
        interpolate_na_device(jnp.asarray(data), max_gap=max_gap))


def _time_index(da, tdim) -> TimeIndex:
    coord = da.coords.get(tdim)
    if coord is None:
        raise XmhwException(f"{tdim} coordinate missing")
    vals = coord.values
    if isinstance(vals, TimeIndex):
        return vals
    vals = np.asarray(vals)
    if np.issubdtype(vals.dtype, np.datetime64):
        t = TimeIndex(vals.astype("datetime64[ns]"))
        t.attrs = dict(coord.attrs)
        return t
    raise XmhwException(
        f"{tdim} coordinate must be datetime-like or a TimeIndex")


def _cell_coords(ts):
    """Component coords labeling the stacked cell axis."""
    return {
        k: np.asarray(c.values)
        for k, c in ts.coords.items()
        if c.dims == ("cell",)
    }


def _scalar_coords(da, tdim):
    out = {}
    for k, c in da.coords.items():
        if c.dims == () and k not in (tdim, "doy"):
            out[k] = c.values
    return out


def threshold(
    temp,
    tdim="time",
    climatologyPeriod=[None, None],
    pctile=90,
    windowHalfWidth=5,
    smoothPercentile=True,
    smoothPercentileWidth=31,
    maxPadLength=None,
    coldSpells=False,
    tstep=False,
    anynans=False,
    skipna=False,
    dtype=None,
    cell_block=None,
    mesh=None,
):
    """Calculate the day-of-year threshold and mean climatology.

    Reference-compatible API (xmhw/xmhw.py:38-247). Notes on semantics:

    * NaN values never enter the percentile pool regardless of ``skipna``
      (the reference's window_roll drops NaNs before the groupby —
      identify.py:208 — so ``skipna`` only toggled an internal code path
      there). The argument is accepted for compatibility.
    * Extras: ``dtype`` (default float32; use float64 on CPU for exact
      reference parity), ``cell_block`` (cells per device step), ``mesh``
      (jax.sharding.Mesh to shard cells over).
    """
    temp = as_dataarray(temp)
    if smoothPercentileWidth % 2 == 0:
        raise XmhwException("smoothPercentileWidth should be odd")
    if tdim not in temp.dims:
        raise XmhwException(
            f"{tdim} dimension not present, default "
            + "is 'time' or pass as tdim='time_dimension_name'"
        )
    if all(climatologyPeriod):
        temp = temp.sel(**{tdim: slice(f"{climatologyPeriod[0]}-01-01",
                                       f"{climatologyPeriod[1]}-12-31")})
    point = len(temp.dims) == 1
    ds_attrs = {"ts": dict(temp.attrs)}
    for c in temp.dims:
        if c in temp.coords:
            ds_attrs[c] = dict(temp.coords[c].attrs)

    ts = temp if point else land_check(temp, tdim=tdim, anynans=anynans)
    tindex = _time_index(ts, tdim)
    year_days = get_calendar(tindex)
    if year_days == 360.0:
        tstep = True
    doy, ndoy = compute_doy(tindex, keep_tstep=tstep)

    data = np.asarray(ts.data, dtype=dtype or np.float32)
    if point:
        data = data[:, None]
    point_host = point and _use_point_host()
    if maxPadLength:
        data = (point_interpolate_na(data, maxPadLength) if point_host
                else _interpolate_na(data, maxPadLength))
    if coldSpells:
        data = -data

    # noleap/365_day calendars NEVER hit doy 60 under the 366-mapping:
    # the reference's groupby('doy') emits the 365 present doys and the
    # 31-day smoother runs over that axis (no synthetic Feb-29 row in
    # the windows) — reproduce that exactly. Standard-calendar data that
    # merely lacks a leap year keeps the dense 366-row axis with the
    # feb29 patch, so a sub-period climatology still covers leap days
    # during detection.
    doy_labels = np.arange(1, ndoy + 1)
    holey = not tstep and year_days == 365
    present = (np.isin(doy_labels, np.unique(doy)) if holey
               else np.ones(ndoy, bool))

    if point_host:
        thresh, seas = point_clim(
            data, doy, windowHalfWidth, ndoy, pctile=pctile,
            smooth=smoothPercentile and not holey,
            smooth_w=smoothPercentileWidth,
            patch_feb29=not tstep and not holey)
    else:
        thresh, seas = run_clim(
            data, doy, windowHalfWidth, ndoy, pctile=pctile,
            smooth=smoothPercentile and not holey,
            smooth_w=smoothPercentileWidth,
            patch_feb29=not tstep and not holey, block=cell_block,
            mesh=mesh,
        )
    if holey:
        doy_labels = doy_labels[present]
        thresh = thresh[present]
        seas = seas[present]
        if smoothPercentile:
            thresh = _runavg_circular_np(thresh, smoothPercentileWidth)
            seas = _runavg_circular_np(seas, smoothPercentileWidth)
        ndoy = len(doy_labels)

    doy_coord = Coord(("doy",), doy_labels)
    q_coord = Coord((), np.float64(pctile / 100.0))
    ds = Dataset()
    if point:
        scal = {k: Coord((), v) for k, v in _scalar_coords(ts, tdim).items()}
        ds["thresh"] = DataArray(
            thresh[:, 0], ("doy",),
            {"doy": doy_coord, "quantile": q_coord, **scal})
        ds["seas"] = DataArray(seas[:, 0], ("doy",),
                               {"doy": doy_coord, **scal})
    else:
        cell_coords = _cell_coords(ts)
        grid_dims = sorted(cell_coords)
        th_full, uniques = unstack_cell(thresh, cell_coords, grid_dims)
        se_full, _ = unstack_cell(seas, cell_coords, grid_dims)
        coords = {"doy": doy_coord}
        for d in grid_dims:
            coords[d] = Coord((d,), uniques[d],
                              ds_attrs.get(d, {}))
        ds["thresh"] = DataArray(th_full, ("doy", *grid_dims),
                                 {**coords, "quantile": q_coord})
        ds["seas"] = DataArray(se_full, ("doy", *grid_dims), coords)

    ds = annotate_ds(ds, ds_attrs, "clim")
    ds.attrs["xmhw_parameters"] = threshold_params_attr(
        pctile, tindex.year[0], tindex.year[-1], windowHalfWidth, skipna,
        smoothPercentile, smoothPercentileWidth, anynans)
    return ds


def _align_clim_cells(clim_da, ts_cell_coords, n_cells, name):
    """Reindex a stacked climatology onto the ts cell order.

    The reference assumes land_check produces identical cell sets for ts
    and th/se (xmhw.py:399-402); here cells are matched explicitly by their
    coordinate labels, raising when a ts cell is missing from the
    climatology.
    """
    clim_coords = _cell_coords(clim_da)
    keys = sorted(ts_cell_coords)
    if sorted(clim_coords) != keys:
        raise XmhwException(
            f"{name} cell coordinates {sorted(clim_coords)} do not match "
            f"the timeseries {keys}")

    # vectorized label join: encode each cell's coordinate tuple as a
    # dense int code (re-densified after every key column so codes stay
    # bounded by the cell counts — no int64 overflow), then one
    # searchsorted. O((E+C) log) instead of a per-cell Python loop.
    n_clim = clim_da.sizes["cell"]
    codes_clim = np.zeros(n_clim, np.int64)
    codes_ts = np.zeros(n_cells, np.int64)
    for k in keys:
        a = np.asarray(clim_coords[k])
        b = np.asarray(ts_cell_coords[k])
        uni, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
        codes_clim = codes_clim * len(uni) + inv[:n_clim]
        codes_ts = codes_ts * len(uni) + inv[n_clim:]
        uni2, inv2 = np.unique(np.concatenate([codes_clim, codes_ts]),
                               return_inverse=True)
        codes_clim, codes_ts = inv2[:n_clim], inv2[n_clim:]
    order = np.argsort(codes_clim, kind="stable")
    sorted_codes = codes_clim[order]
    pos = np.searchsorted(sorted_codes, codes_ts)
    ok = (pos < n_clim) & (sorted_codes[np.minimum(pos, n_clim - 1)]
                           == codes_ts)
    if not ok.all():
        i = int(np.nonzero(~ok)[0][0])
        missing = {k: np.asarray(ts_cell_coords[k])[i] for k in keys}
        raise XmhwException(f"No climatology for cell {missing}")
    return clim_da.isel(cell=order[pos])


def detect(
    temp,
    th,
    se,
    tdim="time",
    minDuration=5,
    joinGaps=True,
    maxGap=2,
    maxPadLength=None,
    coldSpells=False,
    intermediate=False,
    anynans=False,
    tstep=False,
    dtype=None,
    cell_block=None,
    mesh=None,
    events_layout="union",
    reference_quirks=False,
):
    """Apply the Hobday et al. (2016) MHW definition; return event dataset.

    Reference-compatible API (xmhw/xmhw.py:310-518). Returns the event
    Dataset (dims: events [x lat x lon ...]); with ``intermediate=True``
    also returns the per-day intermediate Dataset.

    ``events_layout``: "union" (reference layout — the events dimension is
    the union of start indexes across cells, NaN elsewhere) or "compact"
    (dims (ev, ...) with per-cell event slots — O(max events/cell) instead
    of O(total distinct events); use for planet-scale grids where the
    union layout would explode; block_average/mhw_rank accept both).

    ``reference_quirks=True`` reproduces the reference's fillna(0) artifact
    for exceedance runs that start on day 0 of the record (their first day
    is dropped; a leading run of exactly minDuration days is discarded —
    reference identify.py:441). Default False treats day-0 runs like any
    other run (a deliberate fix; see core/events.py).
    """
    temp = as_dataarray(temp)
    th = as_dataarray(th)
    se = as_dataarray(se)
    if maxGap >= minDuration:
        raise XmhwException(
            "Maximum gap between mhw events should"
            + " be smaller than event minimum duration"
        )
    point = len(temp.dims) == 1
    ds_attrs = {"ts": dict(temp.attrs)}
    for c in temp.coords:
        ds_attrs[c] = dict(temp.coords[c].attrs)

    if point:
        ts, thc, sec = temp, th, se
    else:
        ts = land_check(temp, tdim=tdim, anynans=anynans)
        thc = land_check(th, tdim="doy", anynans=anynans)
        sec = land_check(se, tdim="doy", anynans=anynans)
        cell_coords = _cell_coords(ts)
        ncell = ts.sizes["cell"]
        thc = _align_clim_cells(thc, cell_coords, ncell, "thresh")
        sec = _align_clim_cells(sec, cell_coords, ncell, "seas")

    tindex = _time_index(ts, tdim)
    doy, _ = compute_doy(tindex, keep_tstep=tstep)

    dt = dtype or np.float32
    data = np.asarray(ts.data, dtype=dt)
    th_data = np.asarray(thc.data, dtype=dt)
    se_data = np.asarray(sec.data, dtype=dt)
    if point:
        data, th_data, se_data = (x[:, None] for x in
                                  (data, th_data, se_data))
    point_host = point and _use_point_host()
    if maxPadLength:
        data = (point_interpolate_na(data, maxPadLength) if point_host
                else _interpolate_na(data, maxPadLength))
    if coldSpells:
        data = -data

    # map each timestep's doy onto the climatology's doy rows
    th_doys = np.asarray(thc.get_index("doy") if "doy" in thc.coords
                         else np.arange(1, th_data.shape[0] + 1))
    pos = np.searchsorted(th_doys, doy)
    if (pos >= len(th_doys)).any() or (th_doys[np.clip(pos, 0,
                                       len(th_doys) - 1)] != doy).any():
        raise XmhwException(
            "Climatology doy axis does not cover the timeseries doys")
    doy_pos = pos.astype(np.int32)

    if point_host:
        tables, n_events, inter = point_detect(
            data, th_data, se_data, doy_pos, min_duration=minDuration,
            join_gaps=joinGaps, max_gap=maxGap,
            intermediate=intermediate,
            day0_fillna_quirk=reference_quirks)
    else:
        tables, n_events, inter = run_detect(
            data, th_data, se_data, doy_pos, min_duration=minDuration,
            join_gaps=joinGaps, max_gap=maxGap, intermediate=intermediate,
            block=cell_block, mesh=mesh,
            day0_fillna_quirk=reference_quirks,
            # device point mode (XMHW_POINT_HOST=0): skip the counting
            # pass (one whole program compile) and start at a capacity
            # that covers ~50 years of typical MHW density; the
            # overflow retry handles the rest
            first_k=128 if point else None,
        )

    time_vals = tindex.values
    if events_layout == "compact":
        mhw = _assemble_events_compact(tables, n_events, time_vals, point,
                                       ts, tdim, ds_attrs)
    else:
        mhw = _assemble_events(tables, time_vals, point, ts, tdim,
                               ds_attrs)
    if coldSpells:
        mhw = flip_cold(mhw)
    mhw = annotate_ds(mhw, ds_attrs, "mhw")
    mhw.attrs["xmhw_parameters"] = detect_params_attr(
        minDuration, joinGaps, maxGap, coldSpells, maxPadLength, anynans)
    if not np.issubdtype(np.asarray(time_vals).dtype, np.datetime64):
        # synthetic calendars store raw CF offsets in time_* — carry the
        # units/calendar so block_average/mhw_rank can derive years
        units = (getattr(tindex, "encoding", {}) or {}).get(
            "units") or getattr(tindex, "units", None)
        cal = getattr(tindex, "calendar", "standard")
        if units:
            for v in _TIME_LIKE:
                if v in mhw:
                    mhw[v].attrs.update(units=str(units),
                                        calendar=str(cal))
    if intermediate:
        mhw_inter = _assemble_inter(inter, time_vals, point, ts, tdim,
                                    tindex)
        return mhw, mhw_inter
    return mhw


def _union_geometry(labels):
    """Union of per-cell event labels + scatter geometry.

    Returns (union (E,) int64, rows (Nvalid,), cols (Nvalid,),
    valid (K, C) bool): entry (k, c) of a device table lands at
    [rows, cols] of the (E, C) union layout.
    """
    valid = np.isfinite(labels)
    if valid.any():
        union = np.unique(labels[valid]).astype(np.int64)
    else:
        union = np.zeros(0, np.int64)
    K, C = labels.shape
    rows = np.searchsorted(union, labels[valid].astype(np.int64))
    cols = np.broadcast_to(np.arange(C), (K, C))[valid]
    return union, rows, cols, valid


def _union_values(name, tab, valid, time_vals, time_like):
    """Valid entries of one event variable, time-decoded if needed.

    Returns (values (Nvalid,), fill, storage dtype)."""
    if name in time_like:
        idx = tab[valid].astype(np.int64)
        v = time_vals[np.clip(idx, 0, len(time_vals) - 1)]
        if np.issubdtype(np.asarray(time_vals).dtype, np.datetime64):
            return (np.where(idx >= 0, v, np.datetime64("NaT")),
                    np.datetime64("NaT"), v.dtype)
        return np.where(idx >= 0, v, np.nan), np.nan, np.float64
    return tab[valid], np.nan, tab.dtype


_TIME_LIKE = frozenset({"time_start", "time_end", "time_peak"})


def _assemble_events(tables, time_vals, point, ts, tdim, ds_attrs):
    """Build the events Dataset: union of per-cell event labels.

    The reference's events dimension is the union of start indexes across
    cells, NaN elsewhere (docs/gettingstarted.rst:76-114). The dense
    (K, cell) device tables are scattered DIRECTLY into the final
    (events, lat, lon, ...) grids — one prefaulted allocation and one
    vectorized scatter per variable, no intermediate (E, cell) arrays
    (the round-1 version materialized both and was page-fault bound).
    """
    from .xrlite.alloc import alloc_filled
    from .xrlite.dataarray import grid_positions

    labels = tables["event"]  # (K, C)
    union, rows, cols, valid = _union_geometry(labels)
    E = len(union)
    ev_coord = Coord(("events",), union)
    ds = Dataset()

    if point:
        for name, tab in tables.items():
            tv, fill, dt = _union_values(name, tab, valid, time_vals,
                                         _TIME_LIKE)
            out = np.full(E, fill, dt)
            out[rows] = tv
            ds[name] = DataArray(out, ("events",), {"events": ev_coord})
        for k, v in _scalar_coords(ts, tdim).items():
            ds[k] = DataArray(np.full(E, v), ("events",),
                              {"events": ev_coord})
        return ds

    cell_coords = _cell_coords(ts)
    grid_dims = sorted(cell_coords)
    flat_pos, uniques, grid_shape = grid_positions(cell_coords, grid_dims)
    G = int(np.prod(grid_shape))
    fidx = rows * G + flat_pos[cols]
    coords = {"events": ev_coord}
    for d in grid_dims:
        coords[d] = Coord((d,), uniques[d], ds_attrs.get(d, {}))
    for name, tab in tables.items():
        tv, fill, dt = _union_values(name, tab, valid, time_vals,
                                     _TIME_LIKE)
        out = alloc_filled((E,) + grid_shape, fill, dt)
        out.reshape(-1)[fidx] = tv
        ds[name] = DataArray(out, ("events", *grid_dims), coords)
    return ds


def _assemble_events_compact(tables, n_events, time_vals, point, ts, tdim,
                             ds_attrs):
    """Compact layout: dims (ev, ...) with per-cell event slots.

    Rows beyond a cell's event count are NaN/NaT padded. Memory scales
    with max-events-per-cell, not the global union — the layout for
    planet-scale stats pipelines.
    """
    kmax = max(int(n_events.max()), 1) if n_events.size else 1
    ev_coord = Coord(("ev",), np.arange(kmax),
                     {"long_name": "per-cell MHW event slot"})
    per_var = {}
    for name, tab in tables.items():
        tab = tab[:kmax]
        if name in _TIME_LIKE:
            # same time-index decode as the union layout
            per_var[name], _, _ = _union_values(
                name, tab, np.ones(tab.shape, bool), time_vals,
                _TIME_LIKE)
            per_var[name] = per_var[name].reshape(tab.shape)
        else:
            per_var[name] = tab
    ds = Dataset()
    if point:
        for name, out in per_var.items():
            ds[name] = DataArray(out[:, 0], ("ev",), {"ev": ev_coord})
    else:
        cell_coords = _cell_coords(ts)
        grid_dims = sorted(cell_coords)
        for name, out in per_var.items():
            full, uniques = unstack_cell(out, cell_coords, grid_dims)
            coords = {"ev": ev_coord}
            for d in grid_dims:
                coords[d] = Coord((d,), uniques[d], ds_attrs.get(d, {}))
            ds[name] = DataArray(full, ("ev", *grid_dims), coords)
    return ds


def _assemble_inter(inter, time_vals, point, ts, tdim, tindex=None):
    """Per-day intermediate Dataset (reference: xmhw.py:471-478;
    point-mode keeps the pandas 'index' dim name, grid mode uses time)."""
    dimname = "index" if point else "time"
    tattrs = {}
    if tindex is not None and not np.issubdtype(
            np.asarray(time_vals).dtype, np.datetime64):
        # synthetic calendars keep raw CF offsets: carry units/calendar
        # on the time coord so block_average(dstime=mhw_inter) can
        # derive years (same treatment as the mhw time_* variables)
        units = (getattr(tindex, "encoding", {}) or {}).get(
            "units") or getattr(tindex, "units", None)
        if units:
            tattrs = {"units": str(units),
                      "calendar": str(getattr(tindex, "calendar",
                                              "standard"))}
    tcoord = Coord((dimname,), time_vals, tattrs)
    ds = Dataset()
    if point:
        for name, arr in inter.items():
            ds[name] = DataArray(arr[:, 0], (dimname,), {dimname: tcoord})
        for k, v in _scalar_coords(ts, tdim).items():
            ds[k] = DataArray(np.full(len(time_vals), v), (dimname,),
                              {dimname: tcoord})
    else:
        cell_coords = _cell_coords(ts)
        grid_dims = sorted(cell_coords)
        for name, arr in inter.items():
            full, uniques = unstack_cell(arr, cell_coords, grid_dims)
            coords = {dimname: tcoord}
            for d in grid_dims:
                coords[d] = Coord((d,), uniques[d])
            ds[name] = DataArray(full, (dimname, *grid_dims), coords)
    return ds


def flip_cold(ds):
    """Negate intensity variables for cold-spell output
    (reference: xmhw/features.py:298-315)."""
    for varname in list(ds.keys()):
        if "intensity" in varname and "_var" not in varname:
            ds[varname] = ds[varname] * -1
    return ds
