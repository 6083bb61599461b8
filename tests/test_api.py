"""End-to-end API tests: golden parity (the reference's xfail'd
test_threshold/test_detect, reference: test/test_xmhw.py:24-81, passing
here), land_check, point mode, coldSpells, provenance attrs."""

import numpy as np
import pytest
from numpy import testing as nptest

import xmhw_tpu as xm
from xmhw_tpu.exception import XmhwException


def test_threshold_golden_smooth(oisst_ts, clim_oisst):
    """Match Eric Oliver's marineHeatWaves output at two OISST points
    (reference golden files, xmhw_fixtures.py:31-35)."""
    with pytest.raises(XmhwException):
        xm.threshold(oisst_ts, smoothPercentileWidth=6)
    clim = xm.threshold(oisst_ts, skipna=True, dtype=np.float64)
    th1 = clim["thresh"].sel(lat=-42.625, lon=148.125).values
    se1 = clim["seas"].sel(lat=-42.625, lon=148.125).values
    th2 = clim["thresh"].sel(lat=-41.625, lon=148.375).values
    se2 = clim["seas"].sel(lat=-41.625, lon=148.375).values
    nptest.assert_array_almost_equal(clim_oisst["thresh1"].values[82:],
                                     th1[82:])
    nptest.assert_array_almost_equal(clim_oisst["thresh2"].values[82:],
                                     th2[82:])
    nptest.assert_array_almost_equal(clim_oisst["seas1"].values[82:],
                                     se1[82:], decimal=4)
    nptest.assert_array_almost_equal(clim_oisst["seas2"].values[82:],
                                     se2[82:], decimal=4)


def test_threshold_golden_nosmooth(oisst_ts, clim_oisst_nosmooth):
    clim = xm.threshold(oisst_ts, smoothPercentile=False, skipna=True,
                        dtype=np.float64)
    g = clim_oisst_nosmooth
    nptest.assert_array_almost_equal(
        g["thresh1"].values[60:],
        clim["thresh"].sel(lat=-42.625, lon=148.125).values[60:])
    nptest.assert_array_almost_equal(
        g["seas1"].values[60:],
        clim["seas"].sel(lat=-42.625, lon=148.125).values[60:], decimal=4)
    nptest.assert_array_almost_equal(
        g["thresh2"].values[60:],
        clim["thresh"].sel(lat=-41.625, lon=148.375).values[60:])
    nptest.assert_array_almost_equal(
        g["seas2"].values[60:],
        clim["seas"].sel(lat=-41.625, lon=148.375).values[60:], decimal=4)


def test_threshold_float32_close_to_golden(oisst_ts, clim_oisst):
    """The device dtype (f32) stays within 2e-3 degC of the f64 goldens."""
    clim = xm.threshold(oisst_ts, dtype=np.float32)
    th1 = clim["thresh"].sel(lat=-42.625, lon=148.125).values
    assert np.nanmax(np.abs(th1[82:] - clim_oisst["thresh1"].values[82:])
                     ) < 2e-3


def test_threshold_skipna_equivalent(oisst_ts):
    """NaNs are always dropped from the percentile pool (window_roll
    dropna), so skipna on/off coincide (reference: identify.py:208)."""
    a = xm.threshold(oisst_ts, dtype=np.float64)
    b = xm.threshold(oisst_ts, skipna=True, dtype=np.float64)
    nptest.assert_allclose(a["thresh"].data, b["thresh"].data)


def test_threshold_climatology_period(oisst_ts):
    clim = xm.threshold(oisst_ts, climatologyPeriod=[2003, 2003],
                        dtype=np.float64)
    assert "2003-2003" in clim.attrs["xmhw_parameters"]
    assert clim["thresh"].sizes["doy"] == 366


def test_threshold_missing_tdim(oisst_ts):
    with pytest.raises(XmhwException):
        xm.threshold(oisst_ts, tdim="not_a_dim")


def test_threshold_point_mode(oisst_ts):
    pt = oisst_ts.sel(lat=-42.625, lon=148.125)
    assert len(pt.dims) == 1
    clim = xm.threshold(pt, dtype=np.float64)
    assert clim["thresh"].dims == ("doy",)
    grid = xm.threshold(oisst_ts, dtype=np.float64)
    nptest.assert_allclose(
        clim["thresh"].values,
        grid["thresh"].sel(lat=-42.625, lon=148.125).values)


def test_threshold_attrs(oisst_ts):
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    assert clim.attrs["source"].startswith("xmhw code:")
    assert "Hobday" in clim.attrs["title"]
    assert "90 percentile" in clim.attrs["xmhw_parameters"]
    assert clim["thresh"].attrs["units"] == "degree_C"
    assert clim.coords["doy"].attrs["long_name"] == "Day of the year"


def test_land_check(oisst_ts, landgrid):
    newts = xm.land_check(oisst_ts)
    assert newts.shape == (731, 12)
    fewnans = oisst_ts.copy(data=np.array(oisst_ts.data, copy=True))
    fewnans.data[245, 1, 2] = np.nan
    assert xm.land_check(fewnans, anynans=True).shape == (731, 11)
    assert xm.land_check(fewnans).shape == (731, 12)
    # different dim names
    renamed = xm.DataArray(
        oisst_ts.data, ("c", "a", "b"),
        {"c": oisst_ts.coords["time"], "a": oisst_ts.coords["lat"].values,
         "b": oisst_ts.coords["lon"].values})
    assert xm.land_check(renamed, tdim="c").shape == (731, 12)
    with pytest.raises(XmhwException):
        xm.land_check(landgrid)
    with pytest.raises(XmhwException):
        xm.land_check(oisst_ts.isel(lat=slice(0, 0)))


def test_detect_validation(oisst_ts, clim_oisst):
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    with pytest.raises(XmhwException):
        xm.detect(oisst_ts, clim["thresh"], clim["seas"], minDuration=3,
                  maxGap=5)


def test_detect_grid_consistency(oisst_ts):
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    mhw = xm.detect(oisst_ts, clim["thresh"], clim["seas"],
                    dtype=np.float64)
    # events detected on every ocean cell
    cnt = np.isfinite(mhw["event"].data).sum(axis=0)
    assert (cnt > 0).sum() == 12
    # durations respect minDuration and joining arithmetic
    dur = mhw["duration"].data
    assert np.nanmin(dur) >= 5
    # category consistent with duration flags
    cats = mhw["category"].data
    assert np.nanmax(cats) <= 4
    # event ids are start indexes
    nptest.assert_allclose(mhw["event"].data, mhw["index_start"].data)
    # events coordinate is the union of start indexes
    ev = mhw["events"].values
    assert (np.sort(ev) == ev).all()


def test_detect_point_vs_grid(oisst_ts):
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    mhw = xm.detect(oisst_ts, clim["thresh"], clim["seas"],
                    dtype=np.float64)
    pt_ts = oisst_ts.sel(lat=-42.625, lon=148.125)
    pt_th = clim["thresh"].sel(lat=-42.625, lon=148.125)
    pt_se = clim["seas"].sel(lat=-42.625, lon=148.125)
    mhw_pt = xm.detect(pt_ts, pt_th, pt_se, dtype=np.float64)
    grid_imax = mhw["intensity_max"].sel(lat=-42.625, lon=148.125).values
    pt_imax = mhw_pt["intensity_max"].values
    # same events, ignoring union-padding rows
    nptest.assert_allclose(pt_imax[np.isfinite(pt_imax)],
                           grid_imax[np.isfinite(grid_imax)])


def test_detect_cold_spells(oisst_ts):
    clim = xm.threshold(oisst_ts, coldSpells=True, dtype=np.float64)
    mhw = xm.detect(oisst_ts, clim["thresh"], clim["seas"],
                    coldSpells=True, dtype=np.float64)
    assert "cold events" in mhw.attrs["xmhw_parameters"]
    # cold-spell intensities are flipped negative
    imax = mhw["intensity_max"].data
    assert np.nanmax(imax) < 0
    # but _var stays positive
    assert np.nanmin(mhw["intensity_var"].data) >= 0


def test_detect_params_attr(oisst_ts):
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    mhw = xm.detect(oisst_ts, clim["thresh"], clim["seas"],
                    dtype=np.float64)
    p = mhw.attrs["xmhw_parameters"]
    assert "5 days of minimum duration" in p
    assert "separated by 2 or less days were joined" in p
    assert mhw.attrs["title"].startswith("Marine heatwave events")


def test_netcdf_roundtrip(oisst_ts, tmp_path):
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    path = str(tmp_path / "clim.nc")
    clim.to_netcdf(path)
    back = xm.open_dataset(path)
    nptest.assert_allclose(back["thresh"].data, clim["thresh"].data)
    nptest.assert_allclose(back["seas"].data, clim["seas"].data)
    assert back.attrs["source"] == clim.attrs["source"]
    mhw = xm.detect(oisst_ts, clim["thresh"], clim["seas"],
                    dtype=np.float64)
    path2 = str(tmp_path / "mhw.nc")
    mhw.to_netcdf(path2, encoding={
        "intensity_max": {"dtype": np.float32, "zlib": True}})
    back2 = xm.open_dataset(path2)
    nptest.assert_allclose(
        np.nan_to_num(back2["duration"].data),
        np.nan_to_num(mhw["duration"].data))
    # datetime vars incl. NaT padding survive the CF encode/decode
    np.testing.assert_array_equal(
        np.isnat(back2["time_start"].data),
        np.isnat(mhw["time_start"].data))
    ok = ~np.isnat(mhw["time_start"].data)
    np.testing.assert_array_equal(back2["time_start"].data[ok],
                                  mhw["time_start"].data[ok])


def test_detect_maxpad(oisst_ts):
    data = np.array(oisst_ts.data, copy=True)
    data[100:102, 1, 1] = np.nan
    gappy = oisst_ts.copy(data=data)
    clim = xm.threshold(gappy, dtype=np.float64)
    mhw = xm.detect(gappy, clim["thresh"], clim["seas"], maxPadLength=3,
                    dtype=np.float64)
    assert "interpolation" in mhw.attrs["xmhw_parameters"]


def test_regional_grid_multiblock(oisst_ts):
    """BASELINE config 2 shape: regional grid with a land band, forced
    through MULTIPLE cell blocks (cell_block < n_cells) — block-boundary
    results must equal the single-block run."""
    rng = np.random.default_rng(5)
    t = np.arange("2001-01-01", "2004-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    day = np.arange(T)[:, None, None]
    noise = rng.normal(0, 1, (T + 14, 10, 12))
    sm = np.stack([noise[k:k + T] for k in range(15)]).mean(0)
    data = 14 + 4 * np.sin(2 * np.pi * day / 365.25) + 3 * sm
    data[:, 4:6, :] = np.nan  # land band
    da = xm.DataArray(
        data, ("time", "lat", "lon"),
        {"time": (("time",), t),
         "lat": (("lat",), np.arange(10.0)),
         "lon": (("lon",), np.arange(12.0))})

    clim_multi = xm.threshold(da, dtype=np.float64, cell_block=32)
    clim_one = xm.threshold(da, dtype=np.float64)
    np.testing.assert_array_equal(
        np.nan_to_num(clim_multi["thresh"].data),
        np.nan_to_num(clim_one["thresh"].data))

    mhw_multi = xm.detect(da, clim_one["thresh"], clim_one["seas"],
                          dtype=np.float64, cell_block=32)
    mhw_one = xm.detect(da, clim_one["thresh"], clim_one["seas"],
                        dtype=np.float64)
    for v in ("event", "duration", "intensity_max", "rate_decline"):
        np.testing.assert_array_equal(
            np.nan_to_num(mhw_multi[v].data),
            np.nan_to_num(mhw_one[v].data), err_msg=v)
    # land band dropped from the output grid entirely (land_check +
    # unstack keep only surviving cell labels, like the reference)
    assert 4.0 not in mhw_one.coords["lat"].values
    assert 5.0 not in mhw_one.coords["lat"].values
    assert mhw_one["event"].sizes["lat"] == 8
    # anynans drops cells with any missing value
    data2 = np.array(data, copy=True)
    data2[100, 0, 0] = np.nan
    da2 = da.copy(data=data2)
    c2 = xm.threshold(da2, anynans=True, dtype=np.float64)
    assert np.isnan(c2["thresh"].data[:, 0, 0]).all()


def test_detect_doy_coverage_error(oisst_ts):
    """A climatology whose doy axis doesn't cover the series doys raises
    a clear error instead of mis-gathering."""
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    short_th = clim["thresh"].isel(doy=np.arange(200))
    with pytest.raises(XmhwException):
        xm.detect(oisst_ts, short_th, clim["seas"].isel(
            doy=np.arange(200)), dtype=np.float64)


def test_clim_period_subset_detect_full(oisst_ts):
    """Standard workflow: climatology from a sub-period, detection over
    the full record (reference: climatologyPeriod, xmhw.py:112-119)."""
    clim = xm.threshold(oisst_ts, climatologyPeriod=[2003, 2003],
                        dtype=np.float64)
    mhw = xm.detect(oisst_ts, clim["thresh"], clim["seas"],
                    dtype=np.float64)
    # events found across BOTH years
    y = mhw["time_start"].data.astype("datetime64[Y]")
    years = set(np.unique(y[~np.isnat(y)]).astype(int) + 1970)
    assert {2003, 2004} <= years


def test_intermediate_netcdf_staging(oisst_ts, tmp_path):
    """The reference's documented staging pattern: save the intermediate
    dataset, reload it, feed block_average (docs/gettingstarted.rst)."""
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    mhw, inter = xm.detect(oisst_ts, clim["thresh"], clim["seas"],
                           intermediate=True, dtype=np.float64)
    p = str(tmp_path / "inter.nc")
    inter.to_netcdf(p)
    back = xm.open_dataset(p)
    # grid unstack NaN-fills dropped cells, so bool vars become float
    # (like xarray); values must round-trip exactly
    nptest.assert_allclose(np.nan_to_num(back["bthresh"].data, nan=-1),
                           np.nan_to_num(inter["bthresh"].data, nan=-1))
    nptest.assert_allclose(np.nan_to_num(back["relSeas"].data),
                           np.nan_to_num(inter["relSeas"].data))
    # point-mode intermediate keeps real bools through NetCDF
    pt = oisst_ts.sel(lat=-42.625, lon=148.125)
    cpt = xm.threshold(pt, dtype=np.float64)
    _, ipt = xm.detect(pt, cpt["thresh"], cpt["seas"], intermediate=True,
                       dtype=np.float64)
    p2 = str(tmp_path / "inter_pt.nc")
    ipt.to_netcdf(p2)
    back2 = xm.open_dataset(p2)
    assert back2["bthresh"].data.dtype == bool
    np.testing.assert_array_equal(back2["bthresh"].data,
                                  ipt["bthresh"].data)
    blk = xm.block_average(mhw, dstime=back)
    blk_direct = xm.block_average(mhw, dstime=inter)
    nptest.assert_allclose(np.nan_to_num(blk["total_days"].data),
                           np.nan_to_num(blk_direct["total_days"].data))
    # alternative event-time binning
    blk2 = xm.block_average(mhw, period=[2003, 2004], mtime="time_peak")
    assert np.nansum(blk2["ecount"].data) == np.isfinite(
        mhw["event"].data).sum()
