"""Host-side calendar machinery: day-of-year tables for the climatology.

Calendar structure is data-independent, so everything here is precomputed
once on the host in numpy; only small int32 tables ever reach the device.

Replicates the semantics of the reference's doy handling:

* 366-day day-of-year mapping where 1 March is always doy 61
  (reference: xmhw/identify.py:73-76),
* ``keep_tstep`` mode numbering time steps 1..N within each year for
  non-365/366-day calendars (reference: identify.py:58-71), with the
  complete-years validation raise (identify.py:61-66),
* CF-calendar -> days/year mapping (reference: identify.py:104-113) and
  the 360-day -> force-tstep rule applied by the caller
  (reference: xmhw/xmhw.py:143-144).
"""

from __future__ import annotations

import numpy as np

from ..exception import XmhwException
from ..xrlite.timeutils import TimeIndex, calendar_ndays


def get_calendar(time) -> float:
    """Days-per-year for a time axis (reference: identify.py:82-134).

    Accepts a TimeIndex (or anything with .encoding/.attrs dicts and
    values). Lookup order: encoding['calendar'], attrs['calendar'],
    then the calendar attribute of the first value (cftime-style).
    """
    calendar = ""
    enc = getattr(time, "encoding", None) or {}
    attrs = getattr(time, "attrs", None) or {}
    if "calendar" in enc:
        calendar = enc["calendar"]
    elif "calendar" in attrs:
        calendar = attrs["calendar"]
    else:
        vals = getattr(time, "values", time)
        v0 = np.asarray(vals).flat[0] if np.size(vals) else None
        calendar = getattr(v0, "calendar", "")
        if calendar == "" and isinstance(time, TimeIndex):
            calendar = time.calendar
    return calendar_ndays(str(calendar))


def compute_doy(tindex: TimeIndex, keep_tstep: bool = False):
    """Day-of-year labels for every time step.

    Returns (doy int32 array (T,), ndoy) where ndoy is the number of
    distinct doy values in a full year (366, or steps/year in tstep mode).

    tstep mode counts the steps in the second year of the series
    (reference: identify.py:60 uses years[1]) and requires the series
    length to be a whole number of years.
    """
    if keep_tstep:
        years = np.unique(tindex.year)
        if len(years) < 2:
            raise XmhwException(
                "To use original timestep as climatology base unit, "
                "timeseries has to have complete years"
            )
        oneyear = int(np.sum(tindex.year == years[1]))
        n = len(tindex)
        if oneyear == 0 or n % oneyear != 0:
            raise XmhwException(
                "To use original timestep as climatology base unit, "
                "timeseries has to have complete years"
            )
        nyears = n // oneyear
        doy = np.tile(np.arange(1, oneyear + 1, dtype=np.int32), nyears)
        return doy, oneyear
    return tindex.doy366(), 366


def build_window_index(doy: np.ndarray, w: int, ndoy: int):
    """Static gather table for the windowed doy pooling.

    The reference materializes an 11x-length stacked series per cell
    (window_roll, reference: identify.py:184-209) and then groupby-quantiles
    it (identify.py:233-235). Here we precompute, once for the whole grid,
    the time indices pooled into each doy bucket:

    for every timestep t and offset k in [-w, w], time index t+k (if in
    range) belongs to bucket doy[t]. NaN *values* are additionally dropped
    on device (window_roll's dropna, identify.py:208), so the table only
    encodes positional validity.

    Returns
    -------
    gidx: int32 (ndoy, Z) time indices, padded with -1
    Z: int, max bucket size
    """
    doy = np.asarray(doy)
    T = len(doy)
    width = 2 * w + 1
    offsets = np.arange(-w, w + 1)
    centers = np.repeat(np.arange(T), width)
    member = centers + np.tile(offsets, T)
    valid = (member >= 0) & (member < T)
    bucket = doy[centers] - 1  # 0-based doy
    bucket = bucket[valid]
    member = member[valid]
    # stable counting sort by bucket
    order = np.argsort(bucket, kind="stable")
    bucket = bucket[order]
    member = member[order]
    counts = np.bincount(bucket, minlength=ndoy)
    Z = int(counts.max()) if len(counts) else 0
    gidx = np.full((ndoy, Z), -1, dtype=np.int32)
    # positions within each bucket
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(bucket)) - starts[bucket]
    gidx[bucket, within] = member
    return gidx, Z


def build_window_ranges(doy: np.ndarray, w: int, ndoy: int):
    """Contiguous-range form of the window pooling table (kernel layout).

    Each doy occurs at most once per calendar year (366-mapping and tstep
    numbering both guarantee this), so the pooled set for (doy, year) is
    ONE contiguous time range [t-w, t+w] clipped to the series — the form
    the percentile kernel (ops/pallas/doy_quantile.py) reads as
    start + offset rows instead of a Z-wide gather table.

    Returns (starts (ndoy, NY) int32, lens (ndoy, NY) int32, NY, RMAX)
    where RMAX = 2*w+1. Empty (doy, year) combinations have len 0.
    """
    doy = np.asarray(doy)
    T = len(doy)
    # assign each timestep to a "year chunk": count doy wrap-arounds
    wraps = np.concatenate([[0], (np.diff(doy) < 0).astype(np.int64)])
    yearidx = np.cumsum(wraps)
    NY = int(yearidx[-1]) + 1
    centers_d = doy - 1
    # the one-range-per-(doy, year) form REQUIRES a unique center:
    # direct assignment below would silently keep only the LAST center
    # (e.g. sub-daily data with tstep=False), pooling a smaller set
    # than the gather table and desynchronizing the engines — refuse,
    # callers fall back to the gather path
    flat = centers_d.astype(np.int64) * NY + yearidx
    if len(np.unique(flat)) != T:
        raise ValueError(
            "duplicate (doy, year) centers — the contiguous-range "
            "window table requires each doy at most once per year "
            "(daily data, or tstep=True for sub-daily)")
    starts = np.zeros((ndoy, NY), np.int32)
    lens = np.zeros((ndoy, NY), np.int32)
    lo = np.maximum(np.arange(T) - w, 0)
    hi = np.minimum(np.arange(T) + w + 1, T)
    starts[centers_d, yearidx] = lo.astype(np.int32)
    lens[centers_d, yearidx] = (hi - lo).astype(np.int32)
    return starts, lens, NY, 2 * w + 1
