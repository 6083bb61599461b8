"""Percentile kernel (Pallas, Triton route) in interpret mode on the CPU,
and the engine selection around it. The compiled kernel runs on the card
in tests/test_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xmhw_tpu.core import engine
from xmhw_tpu.core.calendar import (build_window_index,
                                    build_window_ranges, compute_doy)
from xmhw_tpu.core.clim import doy_clim
from xmhw_tpu.ops.pallas import doy_quantile
from xmhw_tpu.ops.pallas.doy_quantile import pallas_doy_clim
from xmhw_tpu.xrlite import TimeIndex


@pytest.fixture(scope="module")
def window_tables():
    t = np.arange("2001-01-01", "2005-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    gidx, _ = build_window_index(doy, 5, ndoy)
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    return len(t), doy, ndoy, gidx, starts, lens, ny, rmax


@pytest.fixture
def gpu_engine(monkeypatch):
    """Select the GPU engine and run its kernel in interpret mode."""
    monkeypatch.setattr(engine, "device_engine", lambda: "gpu")
    monkeypatch.setattr(doy_quantile, "INTERPRET", True)


def _kernel(ts, tables, **kw):
    T, doy, ndoy, gidx, starts, lens, ny, rmax = tables
    return pallas_doy_clim(jnp.asarray(ts), jnp.asarray(starts.reshape(-1)),
                           jnp.asarray(lens.reshape(-1)), ndoy=ndoy, ny=ny,
                           rmax=rmax, interpret=True, **kw)


def test_ranges_equal_gather_table(window_tables):
    T, doy, ndoy, gidx, starts, lens, ny, rmax = window_tables
    for d in range(0, ndoy, 37):
        pool1 = sorted(gidx[d][gidx[d] >= 0].tolist())
        pool2 = []
        for y in range(ny):
            pool2.extend(range(starts[d, y], starts[d, y] + lens[d, y]))
        assert pool1 == sorted(pool2), d


def test_pallas_clim_matches_xla(window_tables):
    """Kernel == doy_clim's float32 radix-select: thresholds bit-equal,
    means to float32 rounding."""
    T, doy, ndoy, gidx, starts, lens, ny, rmax = window_tables
    rng = np.random.default_rng(0)
    # ties (0.01-quantized), negatives, NaN runs, C not a power of two
    ts = np.round(rng.normal(0, 3, (T, 130)), 2).astype(np.float32)
    ts[100:160, 7] = np.nan
    ts[:, 11] = np.nan  # all-NaN (land-like padded) cell
    th0, se0 = doy_clim(jnp.asarray(ts), jnp.asarray(gidx), 90)
    th1, se1 = _kernel(ts, window_tables)
    np.testing.assert_array_equal(np.asarray(th1), np.asarray(th0))
    np.testing.assert_allclose(np.asarray(se1), np.asarray(se0),
                               rtol=1e-6, atol=1e-6, equal_nan=True)
    assert np.isnan(np.asarray(th1)[:, 11]).all()


def test_pipeline_pallas_flag_cpu(window_tables, monkeypatch):
    """On the CPU engine run_clim takes the XLA path: the kernel block
    function is never called."""
    import xmhw_tpu.core.pipeline as P

    def boom(*a, **k):
        raise AssertionError("kernel path taken on the CPU engine")

    monkeypatch.setattr(P, "_kernel_clim_block", boom)
    T, doy, ndoy, gidx, starts, lens, ny, rmax = window_tables
    rng = np.random.default_rng(1)
    ts = rng.normal(15, 2, (T, 40)).astype(np.float32)
    a = P.run_clim(ts, doy, 5, ndoy, 90, True, 31, True)
    assert a[0].shape == (ndoy, 40)


@pytest.mark.parametrize("C", [37, 16, 5])
def test_doy_clim_batched_bit_equal(window_tables, C):
    """Kernel edge cases == doy_clim, bit for bit, with a partial last
    cell tile (37), exactly one tile (16) and fewer cells than a tile
    (5): ties, a constant cell, a sign-crossing cell, a near-zero cell,
    all-NaN cells and a NaN gap."""
    T, doy, ndoy, gidx, starts, lens, ny, rmax = window_tables
    rng = np.random.default_rng(1)
    ts = (15 + rng.normal(0, 2, (T, 37))).astype(np.float32)
    ts[30:90, 1] = np.nan
    ts[:, 2] = 3.25
    ts[:, 3] = rng.normal(0.0, 5.0, T).astype(np.float32)
    ts[:, 4] = np.nan
    ts[:, 36] = np.nan
    ts[:, 13] = rng.normal(0.0, 1e-6, T).astype(np.float32)
    ts[:, 15] = np.round(ts[:, 15])  # heavy ties
    ts = ts[:, :C]
    th0, se0 = doy_clim(jnp.asarray(ts), jnp.asarray(gidx), 90)
    th1, se1 = _kernel(ts, window_tables)
    np.testing.assert_array_equal(np.asarray(th1), np.asarray(th0))
    np.testing.assert_allclose(np.asarray(se1), np.asarray(se0),
                               rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("pctile", [10, 50, 99, 37.5])
def test_pallas_clim_percentiles(window_tables, pctile):
    """Integral and non-integral percentiles select the same order
    statistics as doy_clim."""
    T, doy, ndoy, gidx, starts, lens, ny, rmax = window_tables
    rng = np.random.default_rng(2)
    ts = np.round(rng.normal(20, 1, (T, 9)), 1).astype(np.float32)
    th0, _ = doy_clim(jnp.asarray(ts), jnp.asarray(gidx), pctile)
    th1, _ = _kernel(ts, window_tables, pctile=pctile)
    np.testing.assert_array_equal(np.asarray(th1), np.asarray(th0))


def test_pallas_clim_short_series():
    """A series shorter than a year: many (doy, year) pools are empty
    (NaN rows) and windows clip at both ends."""
    t = np.arange("2001-03-01", "2001-07-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    tables = (len(t), doy, ndoy, build_window_index(doy, 5, ndoy)[0],
              *build_window_ranges(doy, 5, ndoy))
    ts = np.random.default_rng(3).normal(10, 1, (len(t), 5)).astype(
        np.float32)
    th0, se0 = doy_clim(jnp.asarray(ts), jnp.asarray(tables[3]), 90)
    th1, se1 = _kernel(ts, tables)
    np.testing.assert_array_equal(np.asarray(th1), np.asarray(th0))
    assert np.isnan(np.asarray(th1)[0]).all()  # 1 Jan: empty pool


def test_run_clim_gpu_engine_matches_xla(window_tables, gpu_engine):
    """run_clim on the GPU engine (kernel + feb29 + smoothing, blocked)
    == run_clim on the CPU engine."""
    import xmhw_tpu.core.pipeline as P

    T, doy, ndoy, gidx, starts, lens, ny, rmax = window_tables
    ts = np.random.default_rng(4).normal(15, 2, (T, 70)).astype(np.float32)
    ts[:, 5] = np.nan
    got = P.run_clim(ts, doy, 5, ndoy, 90, True, 31, True, block=32)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(engine, "device_engine", lambda: "cpu")
        want = P.run_clim(ts, doy, 5, ndoy, 90, True, 31, True, block=32)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("platform,want", [("cpu", "cpu"), ("gpu", "gpu")])
def test_device_engine_follows_platform(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert engine.device_engine() == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_device_engine_rejects_other_platforms(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no device engine"):
        engine.device_engine()


@pytest.mark.parametrize("eng,dtype,daily,kernel", [
    ("gpu", np.float32, True, True),
    ("gpu", np.float64, True, False),   # the kernel is float32 only
    ("gpu", np.float32, False, False),  # duplicate sub-daily doys
    ("cpu", np.float32, True, False),
])
def test_kernel_clim_choice(monkeypatch, eng, dtype, daily, kernel):
    from xmhw_tpu.core.pipeline import _kernel_clim_tables

    monkeypatch.setattr(engine, "device_engine", lambda: eng)
    doy = np.arange(1, 61) if daily else np.repeat(np.arange(1, 16), 4)
    got = _kernel_clim_tables(np.dtype(dtype), doy, 2, 366)
    assert (got is not None) == kernel
