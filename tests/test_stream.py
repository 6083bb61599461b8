"""Streamed file-to-file pipeline vs the in-memory API.

The stream module automates the reference's manual big-grid workflow
(reference: docs/dask.rst:44-86): stripe reads, device kernels, region
writes. These tests pin byte-level agreement with threshold()/detect()
on a synthetic grid with land, across stripe sizes that force multiple
stripes."""

import os

import numpy as np
import pytest

import xmhw_tpu as xm
from xmhw_tpu.stream import (stream_block_average, stream_detect,
                             stream_rank, stream_threshold)
from xmhw_tpu.xrlite import Coord, DataArray, Dataset


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    rng = np.random.default_rng(42)
    t = np.arange("2000-01-01", "2003-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ny, nx = 12, 8
    day = np.arange(T)[:, None, None]
    sst = (15 + 3 * np.sin(2 * np.pi * day / 365.25)
           + rng.normal(0, 2.2, (T, ny, nx))).astype(np.float64)
    sst[:, 0, 0] = np.nan  # land
    sst[:, 5, 3] = np.nan
    sst[100:104, 2, 2] = np.nan  # short gap
    lat = np.linspace(-40, -30, ny)
    lon = np.linspace(140, 147, nx)
    ds = Dataset()
    tcoord = Coord(("time",), t)
    ds["sst"] = DataArray(
        sst, ("time", "lat", "lon"),
        {"time": tcoord, "lat": Coord(("lat",), lat),
         "lon": Coord(("lon",), lon)}, {"units": "degC"})
    path = tmp_path_factory.mktemp("stream") / "sst.nc"
    xm.save_dataset(ds, str(path))
    return str(path), ds["sst"]


@pytest.mark.parametrize("stripe", [12, 5])
def test_stream_threshold_matches_api(grid_file, tmp_path, stripe):
    path, sst = grid_file
    out = str(tmp_path / f"clim_{stripe}.nc")
    stream_threshold(path, "sst", out, dtype=np.float64, stripe=stripe)
    got = xm.open_dataset(out)
    exp = xm.threshold(sst, dtype=np.float64)
    for v in ("thresh", "seas"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-12, equal_nan=True)
        assert got[v].dims == ("doy", "lat", "lon")
    np.testing.assert_array_equal(got.coords["lat"].values,
                                  exp["thresh"].coords["lat"].values)


@pytest.mark.slow
def test_stream_detect_compact_matches_api(grid_file, tmp_path):
    path, sst = grid_file
    clim_out = str(tmp_path / "clim.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64)
    mhw_out = str(tmp_path / "mhw.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=5, events_layout="compact")
    got = xm.open_dataset(mhw_out)
    clim = xm.threshold(sst, dtype=np.float64)
    exp = xm.detect(sst, clim["thresh"], clim["seas"], dtype=np.float64,
                    events_layout="compact")
    kmax = exp["event"].sizes["ev"]
    for v in ("event", "duration", "intensity_max", "intensity_cumulative",
              "rate_onset", "rate_decline", "severity_var", "category"):
        np.testing.assert_allclose(got[v].data[:kmax], exp[v].data,
                                   atol=1e-9, equal_nan=True)
        assert np.isnan(got[v].data[kmax:]).all()
    for v in ("time_start", "time_end", "time_peak"):
        a = got[v].data[:kmax]
        b = exp[v].data
        np.testing.assert_array_equal(np.isnat(a), np.isnat(b))
        np.testing.assert_array_equal(a[~np.isnat(a)], b[~np.isnat(b)])


@pytest.mark.slow
def test_stream_detect_union_matches_api(grid_file, tmp_path):
    path, sst = grid_file
    clim_out = str(tmp_path / "clim_u.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64)
    mhw_out = str(tmp_path / "mhw_u.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=4, events_layout="union")
    got = xm.open_dataset(mhw_out)
    clim = xm.threshold(sst, dtype=np.float64)
    exp = xm.detect(sst, clim["thresh"], clim["seas"], dtype=np.float64)
    np.testing.assert_array_equal(got.coords["events"].values,
                                  exp["event"].coords["events"].values)
    for v in ("event", "duration", "intensity_max", "intensity_mean",
              "severity_cumulative", "rate_onset"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-9, equal_nan=True)
    for v in ("time_start", "time_peak"):
        a, b = got[v].data, exp[v].data
        np.testing.assert_array_equal(np.isnat(a), np.isnat(b))
        np.testing.assert_array_equal(a[~np.isnat(a)], b[~np.isnat(b)])


def test_stream_threshold_climatology_period(grid_file, tmp_path):
    path, sst = grid_file
    out = str(tmp_path / "clim_p.nc")
    stream_threshold(path, "sst", out, dtype=np.float64,
                     climatologyPeriod=[2000, 2001])
    got = xm.open_dataset(out)
    exp = xm.threshold(sst, dtype=np.float64,
                       climatologyPeriod=[2000, 2001])
    np.testing.assert_allclose(got["thresh"].data, exp["thresh"].data,
                               atol=1e-12, equal_nan=True)


def test_stream_detect_rejects_bad_gap(grid_file, tmp_path):
    path, _ = grid_file
    from xmhw_tpu.exception import XmhwException
    with pytest.raises(XmhwException):
        stream_detect(path, "sst", path, str(tmp_path / "x.nc"),
                      minDuration=3, maxGap=4)


def test_stream_detect_union_partial_stripe(grid_file, tmp_path):
    """ny=12 with stripe=5 leaves a PARTIAL final stripe (2 rows): the
    union writer must still land values there (a flat reshape of the
    non-contiguous buffer view silently dropped them — regression)."""
    path, sst = grid_file
    clim_out = str(tmp_path / "clim_p.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64)
    mhw_out = str(tmp_path / "mhw_p.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=5, events_layout="union")
    got = xm.open_dataset(mhw_out)
    clim = xm.threshold(sst, dtype=np.float64)
    exp = xm.detect(sst, clim["thresh"], clim["seas"], dtype=np.float64)
    # the final partial stripe rows (lat index 10-11) must carry events
    assert np.isfinite(got["event"].data[:, 10:, :]).any()
    for v in ("event", "duration", "intensity_max", "rate_decline"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-9, equal_nan=True)


@pytest.mark.slow
def test_stream_detect_cold_spells_flip(tmp_path):
    """stream_detect(coldSpells=True) applies the flip_cold sign
    convention exactly like api.detect (regression: flip was missing).
    Needs autocorrelated data so multi-day cold runs actually occur."""
    rng = np.random.default_rng(9)
    t = np.arange("2000-01-01", "2003-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ny, nx = 7, 6
    day = np.arange(T)[:, None, None]
    noise = rng.normal(0, 1.0, (T + 14, ny, nx))
    sm = np.stack([noise[k:k + T] for k in range(15)]).mean(0)
    data = (15 + 3 * np.sin(2 * np.pi * day / 365.25) + 3 * sm)
    ds = Dataset()
    ds["sst"] = DataArray(
        data, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.arange(ny, dtype=float)),
         "lon": Coord(("lon",), np.arange(nx, dtype=float))},
        {"units": "degC"})
    path = str(tmp_path / "sst_cold.nc")
    xm.save_dataset(ds, path)
    sst = ds["sst"]
    clim_out = str(tmp_path / "clim_c.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64,
                     coldSpells=True)
    mhw_out = str(tmp_path / "mhw_c.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=5, events_layout="union", coldSpells=True)
    got = xm.open_dataset(mhw_out)
    clim = xm.threshold(sst, coldSpells=True, dtype=np.float64)
    exp = xm.detect(sst, clim["thresh"], clim["seas"], coldSpells=True,
                    dtype=np.float64)
    imax = got["intensity_max"].data
    assert np.nanmax(imax) < 0  # cold-spell intensities are negative
    for v in ("intensity_max", "intensity_cumulative", "intensity_var",
              "duration"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-9, equal_nan=True)


def test_stream_threshold_anynans_matches_api(grid_file, tmp_path):
    """anynans=True drops any-NaN cells in the streamed path exactly like
    land_check does in the API path (cell (2,2) has a 4-day gap)."""
    path, sst = grid_file
    out = str(tmp_path / "clim_any.nc")
    stream_threshold(path, "sst", out, dtype=np.float64, stripe=5,
                     anynans=True)
    got = xm.open_dataset(out)
    exp = xm.threshold(sst, dtype=np.float64, anynans=True)
    # the gap cell must be NaN in both
    assert np.isnan(got["thresh"].data[:, 2, 2]).all()
    for v in ("thresh", "seas"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-12, equal_nan=True)
    assert ("1 NaN along time" in str(got.attrs["xmhw_parameters"]))


def test_stream_detect_anynans_matches_api(grid_file, tmp_path):
    path, sst = grid_file
    clim_out = str(tmp_path / "clim_any2.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64)
    mhw_out = str(tmp_path / "mhw_any.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=5, events_layout="union", anynans=True)
    got = xm.open_dataset(mhw_out)
    clim = xm.threshold(sst, dtype=np.float64)
    exp = xm.detect(sst, clim["thresh"], clim["seas"], dtype=np.float64,
                    anynans=True)
    np.testing.assert_array_equal(got.coords["events"].values,
                                  exp["event"].coords["events"].values)
    # the gap cell (2,2) is dropped entirely under anynans
    assert np.isnan(got["event"].data[:, 2, 2]).all()
    for v in ("event", "duration", "intensity_max", "rate_onset"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-9, equal_nan=True)


def test_stream_detect_maxpadlength_matches_api(grid_file, tmp_path):
    """maxPadLength interpolation applies identically in the streamed
    path (cell (2,2) has a 4-day interior gap that pads away)."""
    path, sst = grid_file
    clim_out = str(tmp_path / "clim_pad.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64,
                     maxPadLength=5)
    mhw_out = str(tmp_path / "mhw_pad.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=5, events_layout="union", maxPadLength=5)
    got = xm.open_dataset(mhw_out)
    clim = xm.threshold(sst, dtype=np.float64, maxPadLength=5)
    exp = xm.detect(sst, clim["thresh"], clim["seas"], dtype=np.float64,
                    maxPadLength=5)
    for v in ("event", "duration", "intensity_max", "intensity_mean",
              "rate_decline"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-9, equal_nan=True)


@pytest.mark.slow
def test_stream_detect_intermediate_matches_api(grid_file, tmp_path):
    path, sst = grid_file
    clim_out = str(tmp_path / "clim_i.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64)
    mhw_out = str(tmp_path / "mhw_i.nc")
    res = stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                        stripe=5, events_layout="union",
                        intermediate=True)
    assert isinstance(res, tuple)
    out_path, inter_path = res
    assert inter_path.endswith("_inter.nc")
    got = xm.open_dataset(inter_path)
    clim = xm.threshold(sst, dtype=np.float64)
    _, exp = xm.detect(sst, clim["thresh"], clim["seas"],
                       dtype=np.float64, intermediate=True)
    assert got["ts"].dims == ("time", "lat", "lon")
    for v in exp.keys():
        e = np.asarray(exp[v].data, np.float64)
        gv = np.asarray(got[v].data, np.float64)
        fin = np.isfinite(e)
        np.testing.assert_allclose(gv[fin], e[fin], atol=1e-9,
                                   err_msg=v)
        # land cells: NaN for float vars, 0 for the int8-encoded bools
        assert (np.isnan(gv[~fin]) | (gv[~fin] == 0)).all(), v
    # time coordinate round-trips (coord values may be a TimeIndex)
    def _tv(c):
        v = c.values
        return np.asarray(getattr(v, "values", v))

    np.testing.assert_array_equal(_tv(got["ts"].coords["time"]),
                                  _tv(exp["ts"].coords["time"]))


@pytest.fixture(scope="module")
def stream_pipeline(grid_file, tmp_path_factory):
    """clim + compact mhw files for the streamed stats-stage tests."""
    path, sst = grid_file
    d = tmp_path_factory.mktemp("streamstats")
    clim_out = str(d / "clim.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64)
    mhw_out = str(d / "mhw.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=5, events_layout="compact")
    return path, sst, clim_out, mhw_out, d


def _inmem_compact(sst):
    clim = xm.threshold(sst, dtype=np.float64)
    mhw = xm.detect(sst, clim["thresh"], clim["seas"], dtype=np.float64,
                    events_layout="compact")
    return clim, mhw


def test_stream_block_average_events_only(stream_pipeline, tmp_path):
    path, sst, clim_out, mhw_out, _ = stream_pipeline
    out = str(tmp_path / "blk.nc")
    stream_block_average(mhw_out, out, period=[2000, 2002], stripe=5)
    got = xm.open_dataset(out)
    _, mhw = _inmem_compact(sst)
    exp = xm.block_average(mhw, period=[2000, 2002])
    np.testing.assert_array_equal(got.coords["years"].values,
                                  exp["ecount"].coords["years"].values)
    for v in exp.keys():
        np.testing.assert_allclose(got[v].data, exp[v].data, rtol=1e-9,
                                   atol=1e-9, equal_nan=True, err_msg=v)


def test_stream_block_average_with_ts_and_cats(stream_pipeline, tmp_path):
    """Full streamed stats: event aggs + per-day ts stats + category-day
    counts, vs the in-memory API fed the equivalent full-series dstime."""
    path, sst, clim_out, mhw_out, _ = stream_pipeline
    out = str(tmp_path / "blk_cats.nc")
    stream_block_average(mhw_out, out, dstime_path=path,
                         dstime_var="sst", clim_path=clim_out, stripe=5)
    got = xm.open_dataset(out)
    clim, mhw = _inmem_compact(sst)
    # build the dstime the reference workflow would use: per-day ts +
    # thresh/seas broadcast from the climatology (stats.py:225-231)
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.xrlite import TimeIndex

    tvals = sst.coords["time"].values
    ti = tvals if isinstance(tvals, TimeIndex) else TimeIndex(
        np.asarray(tvals))
    doy, _ = compute_doy(ti)
    pos = np.searchsorted(np.asarray(clim["thresh"].coords["doy"].values),
                          doy)
    ds = Dataset()
    ds["ts"] = sst
    for v in ("thresh", "seas"):
        ds[v] = DataArray(clim[v].data[pos], ("time", "lat", "lon"),
                          dict(sst.coords))
    exp = xm.block_average(mhw, dstime=ds)
    assert set(got.keys()) >= set(exp.keys())
    for v in exp.keys():
        np.testing.assert_allclose(got[v].data, exp[v].data, rtol=1e-9,
                                   atol=1e-9, equal_nan=True, err_msg=v)


def test_stream_rank_matches_api(stream_pipeline, tmp_path):
    path, sst, clim_out, mhw_out, _ = stream_pipeline
    rp = str(tmp_path / "rank.nc")
    rank_path, return_path = stream_rank(mhw_out, rp, stripe=5)
    got_r = xm.open_dataset(rank_path)
    got_p = xm.open_dataset(return_path)
    _, mhw = _inmem_compact(sst)
    exp_r, exp_p = xm.mhw_rank(mhw)
    kmax = mhw["event"].sizes["ev"]
    for v in exp_r.keys():
        # ranks are small ints (exact in the f4 file storage); return
        # periods round to f4
        np.testing.assert_allclose(got_r[v].data[:kmax], exp_r[v].data,
                                   rtol=1e-6, equal_nan=True, err_msg=v)
        np.testing.assert_allclose(got_p[v].data[:kmax], exp_p[v].data,
                                   rtol=1e-6, equal_nan=True, err_msg=v)


def test_stream_detect_no_events(grid_file, tmp_path):
    """A grid with ocean cells but zero qualifying events writes a valid
    empty-events union file instead of crashing on zero-size chunks."""
    path, sst = grid_file
    clim_out = str(tmp_path / "clim_hi.nc")
    # +5 degC threshold: nothing qualifies
    stream_threshold(path, "sst", clim_out, dtype=np.float64,
                     pctile=100)
    import h5py

    with h5py.File(clim_out, "r+") as f:
        f["thresh"][...] = f["thresh"][...] + 25.0
    mhw_out = str(tmp_path / "mhw_none.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=5, events_layout="union")
    got = xm.open_dataset(mhw_out)
    assert got["event"].sizes["events"] == 0


def test_stream_compressed_outputs_match(grid_file, tmp_path):
    """compress= writes gzip+shuffle chunked variables (the reference's
    documented staging encodes the sparse event output with zlib,
    reference: docs/gettingstarted.rst:64) with byte-identical values."""
    import h5py

    path, sst = grid_file
    c0, c1 = str(tmp_path / "c0.nc"), str(tmp_path / "c1.nc")
    m0, m1 = str(tmp_path / "m0.nc"), str(tmp_path / "m1.nc")
    stream_threshold(path, "sst", c0, dtype=np.float64, stripe=5)
    stream_detect(path, "sst", c0, m0, dtype=np.float64, stripe=5)
    stream_threshold(path, "sst", c1, dtype=np.float64, stripe=5,
                     compress=1)
    stream_detect(path, "sst", c1, m1, dtype=np.float64, stripe=5,
                  compress=1)
    for plain, packed in ((c0, c1), (m0, m1)):
        with h5py.File(plain) as a, h5py.File(packed) as b:
            for v in a:
                if a[v].ndim < 2:
                    continue
                assert b[v].compression == "gzip", v
                np.testing.assert_array_equal(a[v][()], b[v][()],
                                              err_msg=v)
    assert (os.path.getsize(m1) < os.path.getsize(m0)
            and os.path.getsize(c1) < os.path.getsize(c0))


@pytest.mark.slow
def test_stream_run_compressed(grid_file, tmp_path):
    from xmhw_tpu.stream import stream_run

    path, sst = grid_file
    out = stream_run(path, "sst", str(tmp_path / "cc.nc"),
                     str(tmp_path / "mm.nc"),
                     block_path=str(tmp_path / "bb.nc"),
                     rank_path=str(tmp_path / "rr.nc"),
                     dtype=np.float64, stripe=5, compress=1)
    import h5py

    ref_m = str(tmp_path / "m_plain.nc")
    ref_c = str(tmp_path / "c_plain.nc")
    stream_threshold(path, "sst", ref_c, dtype=np.float64, stripe=5)
    stream_detect(path, "sst", ref_c, ref_m, dtype=np.float64, stripe=5)
    with h5py.File(out["mhw"]) as a, h5py.File(ref_m) as b:
        assert a["event"].compression == "gzip"
        np.testing.assert_array_equal(a["event"][()], b["event"][()])
    with h5py.File(out["block"]) as f:
        assert f["ecount"].compression == "gzip"


@pytest.fixture(scope="module")
def packed_grid_file(tmp_path_factory):
    """CF-packed int16 OISST-style file (scale_factor/add_offset +
    integer _FillValue/missing_value) plus the decoded DataArray.

    Real OISST v2/v2.1 products ship SST exactly like this; the
    reference gets decoding for free from xarray (reference:
    requirements.txt:5-8, docs/gettingstarted.rst:40-64). The streamed
    GridReader must apply the same decode."""
    import h5py

    rng = np.random.default_rng(7)
    t = np.arange("2000-01-01", "2003-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ny, nx = 10, 6
    day = np.arange(T)[:, None, None]
    sst = (15 + 3 * np.sin(2 * np.pi * day / 365.25)
           + rng.normal(0, 2.2, (T, ny, nx)))
    sst[:, 0, 0] = np.nan          # land -> fill value
    sst[:, 4, 2] = np.nan
    sst[50:53, 2, 2] = np.nan      # short gap -> missing_value
    sf, ao, fill, miss = 0.01, 10.0, np.int16(-999), np.int16(-32768)
    packed = np.where(np.isnan(sst), fill.astype(np.float64),
                      np.round((sst - ao) / sf)).astype(np.int16)
    packed[50:53, 2, 2] = miss     # exercise missing_value too
    decoded = packed.astype(np.float64) * sf + ao
    decoded[(packed == fill) | (packed == miss)] = np.nan

    path = str(tmp_path_factory.mktemp("packed") / "sst_packed.nc")
    epoch = np.datetime64("2000-01-01", "ns")
    tdays = ((t - epoch) / np.timedelta64(1, "D")).astype(np.float64)
    with h5py.File(path, "w") as f:
        tn = f.create_dataset("time", data=tdays)
        tn.attrs["units"] = "days since 2000-01-01 00:00:00"
        tn.attrs["calendar"] = "standard"
        tn.make_scale("time")
        yn = f.create_dataset("lat", data=np.linspace(-40, -31, ny))
        yn.make_scale("lat")
        xn = f.create_dataset("lon", data=np.linspace(140, 145, nx))
        xn.make_scale("lon")
        v = f.create_dataset("sst", data=packed, dtype="i2")
        v.attrs["scale_factor"] = np.float64(sf)
        v.attrs["add_offset"] = np.float64(ao)
        v.attrs["_FillValue"] = fill
        v.attrs["missing_value"] = miss
        v.attrs["units"] = "degree_C"
        for d, s in zip(v.dims, (tn, yn, xn)):
            d.attach_scale(s)

    da = DataArray(
        decoded, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-40, -31, ny)),
         "lon": Coord(("lon",), np.linspace(140, 145, nx))},
        {"units": "degree_C"})
    return path, da, decoded


def test_gridreader_decodes_cf_packing(packed_grid_file):
    from xmhw_tpu.stream import GridReader

    path, _, decoded = packed_grid_file
    with GridReader(path, "sst") as g:
        # packing attrs are consumed by the decode, units survive
        for k in ("scale_factor", "add_offset", "_FillValue",
                  "missing_value"):
            assert k not in g.attrs
        assert str(g.attrs["units"]) == "degree_C"
        got = g.read(2, 7)
        assert np.issubdtype(got.dtype, np.floating)
        np.testing.assert_allclose(
            got, decoded[:, 2:7].reshape(decoded.shape[0], -1),
            atol=1e-12, equal_nan=True)


def test_stream_threshold_packed_matches_api(packed_grid_file, tmp_path):
    path, da, _ = packed_grid_file
    out = str(tmp_path / "clim_packed.nc")
    stream_threshold(path, "sst", out, dtype=np.float64, stripe=4)
    got = xm.open_dataset(out)
    exp = xm.threshold(da, dtype=np.float64)
    for v in ("thresh", "seas"):
        np.testing.assert_allclose(got[v].data, exp[v].data,
                                   atol=1e-12, equal_nan=True)


def test_stream_detect_packed_matches_api(packed_grid_file, tmp_path):
    path, da, _ = packed_grid_file
    clim_out = str(tmp_path / "clim.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64)
    mhw_out = str(tmp_path / "mhw.nc")
    stream_detect(path, "sst", clim_out, mhw_out, dtype=np.float64,
                  stripe=4, events_layout="compact")
    got = xm.open_dataset(mhw_out)
    clim = xm.threshold(da, dtype=np.float64)
    exp = xm.detect(da, clim["thresh"], clim["seas"], dtype=np.float64,
                    events_layout="compact")
    kmax = exp["event"].sizes["ev"]
    for v in ("event", "duration", "intensity_max", "rate_onset"):
        np.testing.assert_allclose(got[v].data[:kmax], exp[v].data,
                                   atol=1e-9, equal_nan=True)


def test_kcache_persists_discovered_k(grid_file, tmp_path, monkeypatch):
    """A re-run of the same dataset starts at the previously discovered
    event capacity K instead of re-walking 32->64->... (each step is a
    whole-program compile). The table lives in the XLA compile cache
    directory (JAX_COMPILATION_CACHE_DIR) and is keyed by the run's
    parameter+path fingerprint."""
    from xmhw_tpu import stream as st

    path, da = grid_file
    monkeypatch.delenv("XMHW_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    clim_out = str(tmp_path / "clim.nc")
    stream_threshold(path, "sst", clim_out, dtype=np.float64, stripe=5)

    seen = []
    real = st.run_detect

    def spy(*a, **k):
        seen.append(k.get("k_min"))
        return real(*a, **k)

    monkeypatch.setattr(st, "run_detect", spy)
    out1 = str(tmp_path / "m1.nc")
    stream_detect(path, "sst", clim_out, out1, dtype=np.float64,
                  stripe=5, events_layout="compact")
    assert os.path.exists(str(tmp_path / "cache" / "kcache.json"))
    first_walk = seen[0]

    seen.clear()
    out2 = str(tmp_path / "m2.nc")
    stream_detect(path, "sst", clim_out, out2, dtype=np.float64,
                  stripe=5, events_layout="compact")
    # second run: every stripe (including the first) starts at the
    # final K of the first run — no capacity growth, one compile
    assert seen[0] is not None and seen[0] > max(1, first_walk or 1)
    assert seen[0] == max(seen)
    import h5py

    with h5py.File(out1) as a, h5py.File(out2) as b:
        np.testing.assert_array_equal(a["event"][()], b["event"][()])
