"""Host-side helper units: the streamed pipelines' one-ahead stripe
prefetcher (stream._prefetched) and the bench suite's resettable
peak-RSS reporting (bench._peak_rss_gb / _reset_peak_rss)."""

import sys
import threading
import time

import numpy as np
import pytest

from xmhw_tpu.stream import _prefetched


def test_prefetched_order_and_values():
    calls = []

    def fetch(lo, hi):
        calls.append((lo, hi))
        return lo * 100 + hi

    pairs = [(0, 3), (3, 7), (7, 9)]
    out = list(_prefetched(pairs, fetch))
    assert out == [(0, 3, 3), (3, 7, 307), (7, 9, 709)]
    assert calls == pairs  # each stripe fetched exactly once, in order


def test_prefetched_empty():
    assert list(_prefetched([], lambda lo, hi: None)) == []


def test_prefetched_single():
    assert list(_prefetched([(2, 5)], lambda lo, hi: hi - lo)) == [(2, 5, 3)]


def test_prefetched_error_surfaces_at_consumption():
    """A fetch failure on the worker thread re-raises when the consumer
    reaches that stripe — after the earlier stripes were yielded."""

    def fetch(lo, hi):
        if lo == 3:
            raise ValueError("stripe exploded")
        return lo

    got = []
    with pytest.raises(ValueError, match="stripe exploded"):
        for lo, hi, val in _prefetched([(0, 3), (3, 7), (7, 9)], fetch):
            got.append(val)
    assert got == [0]  # first stripe delivered before the failure


def test_prefetched_overlaps_fetch_with_consumption():
    """The next stripe's fetch runs while the consumer processes the
    current one: total wall ~ max-chain, not sum of both sides."""
    fetch_s, consume_s, n = 0.05, 0.05, 4

    def fetch(lo, hi):
        time.sleep(fetch_s)
        return lo

    t0 = time.perf_counter()
    for _lo, _hi, _v in _prefetched([(i, i + 1) for i in range(n)], fetch):
        time.sleep(consume_s)
    wall = time.perf_counter() - t0
    serial = n * (fetch_s + consume_s)
    # perfectly overlapped = fetch_s + n*consume_s; allow generous slack
    assert wall < serial - fetch_s  # must beat fully-serial by >=1 fetch


def test_prefetched_bounded_concurrency():
    """At most ONE fetch is in flight (memory bounded at two stripes)."""
    active = []
    peak = [0]
    lock = threading.Lock()

    def fetch(lo, hi):
        with lock:
            active.append(lo)
            peak[0] = max(peak[0], len(active))
        time.sleep(0.02)
        with lock:
            active.remove(lo)
        return lo

    for _ in _prefetched([(i, i + 1) for i in range(5)], fetch):
        pass
    assert peak[0] == 1


def _import_bench():
    sys.path.insert(0, "/root/repo")
    import bench

    return bench


def test_peak_rss_helpers():
    bench = _import_bench()
    rss = bench._peak_rss_gb()
    assert 0 < rss < 1000
    if bench._reset_peak_rss():  # Linux with /proc/self/clear_refs
        after = bench._peak_rss_gb()
        # watermark resets to ~current RSS; never above the old peak
        assert 0 < after <= rss + 0.001
        # and a fresh allocation raises it again
        x = np.ones(int(50e6 // 8))  # ~50 MB
        x[::4096] = 2.0
        assert bench._peak_rss_gb() >= after


def _vm_rss_mb():
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


def test_arena_trim_releases_retained_pages():
    """maybe_trim_arena returns the glibc arena's fragmented excess to
    the OS (the full-scale RSS fix) without touching live allocations
    or the mmap pool."""
    from xmhw_tpu.xrlite import alloc

    if alloc._libc is None or _vm_rss_mb() is None:
        pytest.skip("needs glibc + /proc")
    if alloc.arena_free_bytes() < 0:
        # without mallinfo2 the bloat guard falls back to a tick
        # cadence and most calls legitimately return False
        pytest.skip("mallinfo2 unavailable")
    alloc.tune_malloc()  # force the no-trim retention policy
    live = np.arange(1_000_000)  # a live allocation that must survive
    # churn ~400 MB of odd-size malloc allocations (plain numpy, below
    # the pool threshold path) so the arena retains them after free
    churn = [np.empty(8_000_000 + 37_000 * i, np.uint8)
             for i in range(50)]
    for a in churn:
        a[::4096] = 1  # touch so the pages are resident
    before_free = _vm_rss_mb()
    del churn
    retained = _vm_rss_mb()
    if retained < before_free - 150:
        pytest.skip("allocator returned pages on free (no retention "
                    "to trim on this libc)")
    assert alloc.maybe_trim_arena(min_free=64 << 20)
    after = _vm_rss_mb()
    assert after < retained - 150, (before_free, retained, after)
    assert (live == np.arange(1_000_000)).all()


def test_arena_trim_threshold_guard():
    """Below the bloat threshold the call is a no-op (steady small runs
    never pay a trim)."""
    from xmhw_tpu.xrlite import alloc

    if alloc._libc is None:
        pytest.skip("needs glibc")
    if alloc.arena_free_bytes() < 0:
        pytest.skip("mallinfo2 unavailable")
    assert alloc.maybe_trim_arena(min_free=1 << 62) is False


def test_arena_trim_forced_bypasses_guard_and_cadence():
    """min_free=0 means 'trim NOW': bench.py/fullscale use it to drop
    each config's churn before resetting the RSS watermark, so it must
    trim even when the arena reads clean and even without mallinfo2
    (the tick cadence must not swallow it)."""
    from xmhw_tpu.xrlite import alloc

    if alloc._libc is None:
        pytest.skip("needs glibc")
    for _ in range(10):  # > the no-mallinfo2 cadence period of 8
        assert alloc.maybe_trim_arena(min_free=0) is True


# ---- review-pass fixes: calendar/netcdf/dataarray edge cases -----------

def test_window_ranges_rejects_duplicate_centers():
    """Sub-daily doys (tstep=False) repeat within a year-chunk: the
    one-range-per-(doy, year) table can't represent that pooled set and
    must refuse (callers fall back to the gather path)."""
    from xmhw_tpu.core.calendar import build_window_ranges

    doy = np.repeat(np.arange(1, 21), 4)  # 6-hourly: 4 steps per day
    with pytest.raises(ValueError, match="duplicate"):
        build_window_ranges(doy, 2, 366)
    # daily doys are fine
    build_window_ranges(np.arange(1, 21), 2, 366)


def test_run_clim_subdaily_falls_back_to_gather(monkeypatch):
    """run_clim with duplicated doys must fall back to the XLA gather
    path (pooling everything) instead of silently using a wrong range
    table — engines must agree."""
    from xmhw_tpu.core import engine
    from xmhw_tpu.core.pipeline import run_clim
    from xmhw_tpu.ops.pallas import doy_quantile

    rng = np.random.default_rng(0)
    reps, days = 4, 60
    doy = np.repeat(np.arange(1, days + 1), reps).astype(np.int64)
    ts = rng.normal(15, 2, (days * reps, 4)).astype(np.float32)
    th_ref, se_ref = run_clim(ts, doy, 2, 366, 90, False, 31, False)
    monkeypatch.setattr(engine, "device_engine", lambda: "gpu")
    monkeypatch.setattr(doy_quantile, "INTERPRET", True)
    th_forced, se_forced = run_clim(ts, doy, 2, 366, 90, False, 31,
                                    False)
    np.testing.assert_allclose(np.asarray(th_forced),
                               np.asarray(th_ref), equal_nan=True)
    np.testing.assert_allclose(np.asarray(se_forced),
                               np.asarray(se_ref), equal_nan=True)


def test_save_dataset_dim_named_data_var_roundtrip(tmp_path):
    """A data variable named after its own dim is a coordinate variable
    (xarray semantics): its VALUES must survive the round trip."""
    import xmhw_tpu as xm
    from xmhw_tpu.xrlite import Coord, DataArray, Dataset

    ds = Dataset()
    ds["depth"] = DataArray(np.array([10., 20., 30., 40.]), ("depth",))
    ds["temp"] = DataArray(np.arange(4.0), ("depth",))
    p = str(tmp_path / "d.nc")
    xm.save_dataset(ds, p)
    back = xm.open_dataset(p)
    np.testing.assert_array_equal(
        np.asarray(back["temp"].coords["depth"].values),
        [10., 20., 30., 40.])


def test_open_dataset_unattached_dimension_axis(tmp_path):
    """A variable axis with an empty DIMENSION_LIST entry (no attached
    scale) gets a synthetic dim name instead of IndexError."""
    import h5py

    import xmhw_tpu as xm

    p = str(tmp_path / "p.nc")
    with h5py.File(p, "w") as f:
        lat = f.create_dataset("lat", data=np.arange(3.0))
        lat.make_scale("lat")
        v = f.create_dataset("v", data=np.zeros((2, 3)))
        v.dims[1].attach_scale(lat)  # dim 0 left unattached
    ds = xm.open_dataset(p)
    assert ds["v"].dims[1] == "lat"
    assert ds["v"].dims[0].startswith("dim_")


def test_dataarray_accepts_bare_timeindex_coord():
    """xarray-style bare coords value: a TimeIndex passed directly (not
    wrapped in Coord/tuple) must work."""
    from xmhw_tpu.xrlite import DataArray, TimeIndex

    t = TimeIndex(np.arange("2000-01-01", "2000-01-11",
                            dtype="datetime64[D]").astype(
                                "datetime64[ns]"))
    da = DataArray(np.zeros((10, 2)), ("time", "cell"), {"time": t})
    assert len(da.coords["time"].values) == 10


def test_sel_descending_datetime_partial_slice():
    """Partial date-string slices on a DESCENDING time axis must select
    whole periods, bounds in coord order (later, earlier)."""
    from xmhw_tpu.xrlite import DataArray

    t = np.arange("2003-01-01", "2003-04-01",
                  dtype="datetime64[D]")[::-1].astype("datetime64[ns]")
    da = DataArray(np.arange(len(t), dtype=float), ("time",),
                   {"time": ("time", t)})
    out = da.sel(time=slice("2003-03", "2003-02"))
    got = np.asarray(out.coords["time"].values)
    assert len(got) == 59  # all of Feb (28) + Mar (31)
    assert got[0] == np.datetime64("2003-03-31", "ns")
    assert got[-1] == np.datetime64("2003-02-01", "ns")
    # ascending stays correct
    da2 = DataArray(np.arange(len(t), dtype=float), ("time",),
                    {"time": ("time", t[::-1])})
    out2 = da2.sel(time=slice("2003-02", "2003-03"))
    assert len(np.asarray(out2.coords["time"].values)) == 59
