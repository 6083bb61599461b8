"""Calendar-aware time axis handling (cftime replacement).

The reference relies on xarray + cftime for CF-calendar decoding
(reference: xmhw/identify.py:82-134 reads ``calendar`` from encoding/attrs).
Neither library is a dependency of this framework, so we implement the small
subset needed for marine-heatwave work:

* parsing CF ``units`` strings ("days since 1978-01-01 12:00:00"),
* decoding raw offsets into (year, month, day, dayofyear) fields for the
  standard/proleptic_gregorian family (via numpy datetime64) and for the
  synthetic climate-model calendars (noleap/365_day, all_leap/366_day,
  360_day) via direct arithmetic,
* mapping a calendar name to days-per-year (reference: identify.py:104-113).

Everything here is host-side numpy: calendar structure is data-independent,
so it is precomputed once and only small int32 tables (day-of-year indices)
ever reach the device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

# Days per year by CF calendar name (reference: identify.py:104-113).
CALENDAR_NDAYS = {
    "standard": 365.25,
    "gregorian": 365.25,
    "proleptic_gregorian": 365.25,
    "all_leap": 366,
    "366_day": 366,
    "noleap": 365,
    "365_day": 365,
    "360_day": 360,
    "julian": 365.25,
}

# Calendars that numpy datetime64 handles natively.
_DT64_CALENDARS = {"standard", "gregorian", "proleptic_gregorian", ""}
# julian is decoded arithmetically: its leap rule (every 4th year, no
# century exception — 1900 IS a julian leap year) differs from the
# proleptic-gregorian arithmetic datetime64 uses, so mapping it onto
# datetime64 would shift dates vs the reference's cftime decoding

# month lengths for the synthetic calendars
_DAYS_IN_MONTH_365 = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
_DAYS_IN_MONTH_366 = np.array([31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])

_UNITS_RE = re.compile(
    r"^\s*(?P<unit>seconds|minutes|hours|days|weeks|months|years)\s+since\s+"
    r"(?P<year>\d{1,4})-(?P<month>\d{1,2})-(?P<day>\d{1,2})"
    r"(?:[T\s]+(?P<hour>\d{1,2}):(?P<minute>\d{1,2})"
    r"(?::(?P<second>\d{1,2}(?:\.\d*)?))?)?",
    re.IGNORECASE,
)

_UNIT_SECONDS = {
    "seconds": 1.0,
    "minutes": 60.0,
    "hours": 3600.0,
    "days": 86400.0,
    "weeks": 7 * 86400.0,
}


def normalize_calendar(calendar: str) -> str:
    """Normalize loosely-specified calendar names.

    The reference tolerates "360"/"365"/"366" and "leap"
    (reference: identify.py:125-128).
    """
    calendar = (calendar or "").lower()
    if calendar in ("360", "365", "366"):
        calendar = f"{calendar}_day"
    elif calendar == "leap":
        calendar = "standard"
    return calendar


def calendar_ndays(calendar: str) -> float:
    """Days per year for a CF calendar; unknown names fall back to 365.25
    with a warning (reference: identify.py:129-133)."""
    calendar = normalize_calendar(calendar)
    if calendar == "":
        return 365.25
    if calendar not in CALENDAR_NDAYS:
        print("calendar not in keys")
        return 365.25
    return CALENDAR_NDAYS[calendar]


def parse_cf_units(units: str):
    """Parse a CF time-units string -> (seconds_per_step, epoch tuple).

    Returns (step_seconds, (year, month, day, hour, minute, second)).
    """
    m = _UNITS_RE.match(units)
    if m is None:
        raise ValueError(f"Cannot parse CF time units: {units!r}")
    g = m.groupdict()
    unit = g["unit"].lower()
    if unit not in _UNIT_SECONDS:
        raise ValueError(f"Unsupported CF time unit: {unit!r}")
    epoch = (
        int(g["year"]),
        int(g["month"]),
        int(g["day"]),
        int(g["hour"] or 0),
        int(g["minute"] or 0),
        float(g["second"] or 0.0),
    )
    return _UNIT_SECONDS[unit], epoch


def _is_leap_gregorian(year: np.ndarray) -> np.ndarray:
    return ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)


@dataclass
class TimeIndex:
    """A decoded time axis with calendar-aware date fields.

    Replaces the xarray ``.dt`` accessor used throughout the reference
    (e.g. ``t.dt.dayofyear``, ``t.dt.month``, ``t.dt.is_leap_year`` at
    reference identify.py:73-76). ``values`` holds numpy datetime64[ns] for
    real-world calendars or raw numeric offsets for synthetic calendars.
    """

    values: np.ndarray
    calendar: str = "standard"
    units: str | None = None  # original CF units for synthetic calendars
    attrs: dict = field(default_factory=dict)
    encoding: dict = field(default_factory=dict)

    # decoded fields (lazily computed)
    _fields: dict | None = None

    def __len__(self):
        return len(self.values)

    def __getitem__(self, key):
        sub = TimeIndex(
            np.atleast_1d(self.values[key]),
            calendar=self.calendar,
            units=self.units,
            attrs=dict(self.attrs),
            encoding=dict(self.encoding),
        )
        return sub

    # -- decoding ---------------------------------------------------------
    def _decode(self) -> dict:
        if self._fields is not None:
            return self._fields
        cal = normalize_calendar(self.calendar)
        if cal in _DT64_CALENDARS and np.issubdtype(
            np.asarray(self.values).dtype, np.datetime64
        ):
            f = _decode_dt64(np.asarray(self.values))
        else:
            if self.units is None:
                raise ValueError(
                    f"Synthetic calendar {cal!r} requires CF units metadata"
                )
            f = _decode_synthetic(np.asarray(self.values), self.units, cal)
        self._fields = f
        return f

    @property
    def year(self) -> np.ndarray:
        return self._decode()["year"]

    @property
    def month(self) -> np.ndarray:
        return self._decode()["month"]

    @property
    def day(self) -> np.ndarray:
        return self._decode()["day"]

    @property
    def dayofyear(self) -> np.ndarray:
        return self._decode()["dayofyear"]

    @property
    def is_leap_year(self) -> np.ndarray:
        return self._decode()["is_leap_year"]

    # reference: identify.py:73-76 — 366-day day-of-year mapping where
    # 1 March is always doy 61 (non-leap years skip doy 60 / Feb-29).
    def doy366(self) -> np.ndarray:
        f = self._decode()
        shift = (~f["is_leap_year"]) & (f["month"] >= 3)
        return (f["dayofyear"] + shift).astype(np.int32)


def _decode_dt64(values: np.ndarray) -> dict:
    """Decode datetime64 values into date fields using pure numpy."""
    days = values.astype("datetime64[D]")
    years_arr = values.astype("datetime64[Y]")
    year = years_arr.astype(int) + 1970
    month = (values.astype("datetime64[M]").astype(int) % 12) + 1
    day = (days - values.astype("datetime64[M]")).astype(int) + 1
    doy = (days - years_arr).astype(int) + 1
    return {
        "year": year,
        "month": month,
        "day": day,
        "dayofyear": doy,
        "is_leap_year": _is_leap_gregorian(year),
    }


def _decode_julian(raw: np.ndarray, units: str) -> dict:
    """Decode raw CF offsets on the proleptic JULIAN calendar (leap
    every 4th year, no century exception)."""
    step_seconds, epoch = parse_cf_units(units)
    ey, em, ed = epoch[0], epoch[1], epoch[2]

    def days_before_year(y):
        return 365 * y + (y + 3) // 4  # leap years among 0..y-1

    e_leap = ey % 4 == 0
    e_mstart = np.concatenate(
        [[0], np.cumsum(_DAYS_IN_MONTH_366 if e_leap
                        else _DAYS_IN_MONTH_365)])
    epoch_day = (days_before_year(ey) + e_mstart[em - 1] + (ed - 1))
    total_days = (
        np.asarray(raw, dtype=np.float64) * step_seconds / 86400.0
        + epoch_day
        + (epoch[3] * 3600 + epoch[4] * 60 + epoch[5]) / 86400.0
    )
    day_int = np.floor(total_days).astype(np.int64)
    # 4-year cycle of 1461 days; year 0 of each cycle is the leap year
    quad, rem = day_int // 1461, day_int % 1461
    yo = np.where(rem < 366, 0, 1 + (rem - 366) // 365)
    doy0 = rem - np.array([0, 366, 731, 1096])[yo]
    year = quad * 4 + yo
    leap = yo == 0
    ms365 = np.concatenate([[0], np.cumsum(_DAYS_IN_MONTH_365)])
    ms366 = np.concatenate([[0], np.cumsum(_DAYS_IN_MONTH_366)])
    m365 = np.searchsorted(ms365, doy0, side="right")
    m366 = np.searchsorted(ms366, doy0, side="right")
    month = np.where(leap, m366, m365)
    day = doy0 - np.where(leap, ms366[m366 - 1], ms365[m365 - 1]) + 1
    return {
        "year": year.astype(np.int64),
        "month": month.astype(np.int64),
        "day": day.astype(np.int64),
        "dayofyear": (doy0 + 1).astype(np.int64),
        "is_leap_year": leap,
    }


def _decode_synthetic(raw: np.ndarray, units: str, calendar: str) -> dict:
    """Decode raw CF offsets for noleap/all_leap/360_day/julian."""
    if calendar == "julian":
        return _decode_julian(raw, units)
    step_seconds, epoch = parse_cf_units(units)
    ndays = {"noleap": 365, "365_day": 365, "all_leap": 366, "366_day": 366,
             "360_day": 360}[calendar]
    if calendar == "360_day":
        dim = np.full(12, 30)
    elif ndays == 365:
        dim = _DAYS_IN_MONTH_365
    else:
        dim = _DAYS_IN_MONTH_366
    month_start = np.concatenate([[0], np.cumsum(dim)])  # day-of-year offsets

    ey, em, ed = epoch[0], epoch[1], epoch[2]
    epoch_day_of_year = month_start[em - 1] + (ed - 1)
    total_days = (
        np.asarray(raw, dtype=np.float64) * step_seconds / 86400.0
        + ey * ndays
        + epoch_day_of_year
        + (epoch[3] * 3600 + epoch[4] * 60 + epoch[5]) / 86400.0
    )
    day_int = np.floor(total_days).astype(np.int64)
    year = day_int // ndays
    doy0 = day_int - year * ndays  # 0-based day of year
    month = np.searchsorted(month_start, doy0, side="right")  # 1..12
    day = doy0 - month_start[month - 1] + 1
    return {
        "year": year.astype(np.int64),
        "month": month.astype(np.int64),
        "day": day.astype(np.int64),
        "dayofyear": (doy0 + 1).astype(np.int64),
        "is_leap_year": np.full(raw.shape, ndays == 366, dtype=bool),
    }


def decode_cf_time(raw: np.ndarray, units: str, calendar: str = "standard"):
    """Decode raw CF-encoded time values to a TimeIndex.

    Standard-family calendars become numpy datetime64[ns]; synthetic
    calendars keep raw offsets and decode dates arithmetically.
    """
    calendar = normalize_calendar(calendar)
    if calendar in _DT64_CALENDARS:
        step_seconds, (y, mo, d, h, mi, s) = parse_cf_units(units)
        # compute in DAY resolution first: CF epochs like
        # "days since 0001-01-01" are outside the datetime64[ns] range
        # (~1678-2262) and would silently wrap if built in ns — only the
        # decoded DATA timestamps need to be ns-representable
        epoch_days = (np.datetime64(f"{y:04d}-{mo:02d}-{d:02d}", "D")
                      - np.datetime64("1970-01-01", "D")).astype(np.int64)
        rawf = np.asarray(raw, dtype=np.float64)
        fin = np.isfinite(rawf)
        safe = np.where(fin, rawf, 0.0)
        days = (safe * (step_seconds / 86400.0)
                + (h * 3600 + mi * 60 + s) / 86400.0)
        dint = np.floor(days)
        frac_ns = np.round((days - dint) * 86400.0 * 1e9).astype(np.int64)
        abs_days = epoch_days + dint.astype(np.int64)
        if fin.any() and (np.abs(abs_days[fin]).max() > 106_750):
            raise ValueError(
                f"time values decoded from units {units!r} fall outside "
                "the datetime64[ns] range (years ~1678-2262)")
        values = (np.datetime64("1970-01-01", "ns")
                  + abs_days.astype("timedelta64[D]").astype(
                      "timedelta64[ns]")
                  + frac_ns.astype("timedelta64[ns]"))
        if not fin.all():  # NaN fill -> NaT, explicitly
            values = np.where(fin, values, np.datetime64("NaT"))
        return TimeIndex(values, calendar=calendar or "standard", units=units)
    return TimeIndex(np.asarray(raw), calendar=calendar, units=units)


def encode_cf_time(tindex: TimeIndex, units: str | None = None):
    """Encode a TimeIndex back to raw values + (units, calendar)."""
    cal = normalize_calendar(tindex.calendar)
    if np.issubdtype(np.asarray(tindex.values).dtype, np.datetime64):
        units = units or "days since 1970-01-01 00:00:00"
        step_seconds, (y, mo, d, h, mi, s) = parse_cf_units(units)
        # day-resolution arithmetic: the epoch may be outside the ns
        # range (e.g. "days since 0001-01-01") — see decode_cf_time
        epoch_days = (np.datetime64(f"{y:04d}-{mo:02d}-{d:02d}", "D")
                      - np.datetime64("1970-01-01", "D")).astype(np.int64)
        nat = np.isnat(tindex.values)
        vals = np.where(nat, np.datetime64(0, "ns"), tindex.values)
        vdays = vals.astype("datetime64[D]")
        intra_ns = (vals - vdays).astype("timedelta64[ns]").astype(
            np.int64)
        day_off = (vdays - np.datetime64("1970-01-01", "D")).astype(
            np.int64) - epoch_days
        raw = ((day_off * 86400.0 + intra_ns / 1e9
                - (h * 3600 + mi * 60 + s)) / step_seconds)
        if nat.any():
            # NaT must round-trip as the declared float fill (NaN), not
            # as INT64_MIN's offset (-106751.99 days, which external
            # readers would decode as a year-1677 date)
            raw = np.where(nat, np.nan, raw)
        elif np.all(raw == np.round(raw)):
            raw = raw.astype(np.int64)
        return raw, units, cal or "standard"
    return tindex.values, tindex.units or units, cal
