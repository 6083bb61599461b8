"""Test configuration: CPU backend with 8 virtual devices + float64.

Tests run on the CPU (float64 available -> exact parity with the
reference's pandas/float64 numerics); the 8 virtual devices let the
sharding tests exercise a real multi-device mesh. Tests that need an
NVIDIA GPU carry the ``gpu`` marker and run on the card with

    python -m pytest -m gpu tests/

which keeps JAX's default backend and float32; elsewhere they skip, by
the ``gpu`` fixture below.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
# keep the suite's streamed runs out of the persistent caches (compile
# cache + kcache.json); individual tests monkeypatch their own
os.environ.setdefault("XMHW_COMPILE_CACHE", "0")

import jax  # noqa: E402


def pytest_configure(config):
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)


import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

import xmhw_tpu as xm  # noqa: E402
from xmhw_tpu.xrlite import Coord, DataArray  # noqa: E402

# golden OISST fixtures from the reference checkout; point XMHW_TESTDATA
# elsewhere (or leave the path absent, e.g. on CI runners, to skip the
# golden-data tests)
TESTDATA = os.environ.get("XMHW_TESTDATA", "/root/reference/test/testdata")


def _golden(fname):
    path = os.path.join(TESTDATA, fname)
    if not os.path.exists(path):
        pytest.skip(f"golden test data not available: {path} "
                    "(set XMHW_TESTDATA)")
    return xm.open_dataset(path)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU (decided here,
    at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/")


@pytest.fixture(scope="session")
def oisst_ts():
    return _golden("oisst_2003_2004.nc")["sst"]


@pytest.fixture(scope="session")
def landgrid():
    return _golden("land.nc")["sst"]


@pytest.fixture(scope="session")
def clim_oisst():
    return _golden("test_clim_oisst.nc")


@pytest.fixture(scope="session")
def clim_oisst_nosmooth():
    return _golden("test_clim_oisst_nosmooth.nc")


@pytest.fixture(scope="session")
def dsnorm():
    # reference-pipeline per-day event labels + relThreshNorm
    # (reference: test/xmhw_fixtures.py:36,64-66)
    return _golden("relthreshnorm.nc")


@pytest.fixture
def oisst_doy():
    # expected 366-calendar doys for 2003 (non-leap) + 2004 (leap)
    a = np.arange(1, 367)
    b = np.delete(a, [59])
    return np.concatenate((b, a))


@pytest.fixture
def filter_data():
    """29-day exceedance pattern with expected events for minDuration=5
    and for maxGap=3 joining (mirrors the reference's filter fixture)."""
    a = np.array(
        [0, 1, 1, 1, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 1,
         1, 1, 1, 1, 0, 0, 0, 0], dtype=bool)
    exp = np.full(29, -1)
    exp[1:6] = 1
    exp[11:17] = 11
    exp[20:25] = 20
    exp_joined = np.full(29, -1)
    exp_joined[1:6] = 1
    exp_joined[11:25] = 11
    return a, exp, exp_joined


@pytest.fixture
def define_data():
    """1-cell 9-day dataset for the event feature engine (reference
    define_data fixture)."""
    time = pd.date_range("2001-01-01", periods=9).values
    ts = DataArray(
        np.array([15.6, 17.3, 18.2, 19.5, 19.4, 19.6, 18.1, 17.0,
                  15.2]).reshape(9, 1, 1),
        ("time", "lat", "lon"),
        {"time": Coord(("time",), time),
         "lat": Coord(("lat",), [45.5]),
         "lon": Coord(("lon",), [123.4])},
    )
    se = DataArray(
        np.array([15.8, 16.0, 16.2, 16.5, 16.6, 16.4, 16.6, 16.7,
                  16.4]).reshape(9, 1, 1),
        ("doy", "lat", "lon"),
        {"doy": Coord(("doy",), np.arange(1, 10)),
         "lat": Coord(("lat",), [45.5]),
         "lon": Coord(("lon",), [123.4])},
    )
    th = DataArray(
        np.array([16.0, 16.7, 17.6, 17.9, 18.1, 18.2, 17.3, 17.2,
                  17.0]).reshape(9, 1, 1),
        ("doy", "lat", "lon"),
        {"doy": Coord(("doy",), np.arange(1, 10)),
         "lat": Coord(("lat",), [45.5]),
         "lon": Coord(("lon",), [123.4])},
    )
    return ts, th, se


@pytest.fixture
def mhw_expected():
    """Expected event properties (reference mhw_data fixture)."""
    return {
        "event": 1.0,
        "index_start": 1.0,
        "index_end": 6.0,
        "intensity_max": 3.2,
        "intensity_mean": 2.3,
        "intensity_cumulative": 13.8,
        "severity_max": -1.42857,
        "severity_mean": -1.86931,
        "severity_cumulative": -11.215873,
        "severity_var": 0.265495,
        "intensity_mean_relThresh": 1.05,
        "intensity_cumulative_relThresh": 6.30,
        "intensity_mean_abs": 18.6834,
        "intensity_cumulative_abs": 112.1,
        "duration_moderate": 4,
        "duration_strong": 2,
        "duration_severe": 0,
        "duration_extreme": 0,
        "index_peak": 5.0,
        "intensity_var": 0.809938,
        "intensity_max_relThresh": 1.40,
        "intensity_max_abs": 19.6,
        "intensity_var_relThresh": 0.437035,
        "intensity_var_abs": 0.9495613,
        "category": 2.0,
        "duration": 6.0,
        "rate_onset": 0.5888889,
        "rate_decline": 1.5333333,
    }


@pytest.fixture
def inter_expected():
    """Expected per-day intermediate values (reference inter_data)."""
    nan = np.nan
    return {
        "ts": [15.6, 17.3, 18.2, 19.5, 19.4, 19.6, 18.1, 17.0, 15.2],
        "seas": [nan, 16.0, 16.2, 16.5, 16.6, 16.4, 16.6, nan, nan],
        "thresh": [nan, 16.7, 17.6, 17.9, 18.1, 18.2, 17.3, nan, nan],
        "bthresh": [False, True, True, True, True, True, True, False,
                    False],
        "events": [nan, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, nan, nan],
        "relSeas": [nan, 1.3, 2.0, 3.0, 2.79999, 3.2, 1.5, nan, nan],
        "relThresh": [nan, 0.6, 0.6, 1.6, 1.3, 1.4, 0.8, nan, nan],
        "relThreshNorm": [nan, 0.85714, 0.4285714, 1.142857, 0.866667,
                          0.77778, 1.142857, nan, nan],
        "severity": [nan, -1.857143, -1.42857, -2.142857, -1.8666667,
                     -1.77778, -2.142857, nan, nan],
        "cats": [nan, 1.0, 1.0, 2.0, 1.0, 1.0, 2.0, nan, nan],
        "duration_moderate": [False, True, True, False, True, True, False,
                              False, False],
        "duration_strong": [False, False, False, True, False, False, True,
                            False, False],
        "duration_severe": [False] * 9,
        "duration_extreme": [False] * 9,
        "mabs": [nan, 17.3, 18.2, 19.5, 19.4, 19.6, 18.1, nan, nan],
    }
