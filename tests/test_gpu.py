"""Compiled GPU paths on the card vs the float64 oracle and the XLA engine.

The rest of the suite runs on the CPU, with the Pallas percentile kernel
in interpret mode; these tests run what the GPU compiler makes of it.
Run on the card with:

    python -m pytest -m gpu tests/

Elsewhere they skip (the ``gpu`` fixture decides at run time).
"""

import numpy as np
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


def _series(T, C, seed=0):
    rng = np.random.default_rng(seed)
    day = np.arange(T, dtype=np.float32)[:, None]
    base = 15 + 3 * np.sin(2 * np.pi * day / 365.25)
    noise = rng.normal(0, 1.0, (T + 14, C)).astype(np.float32)
    sm = np.cumsum(noise, axis=0)
    sm = (sm[14:] - np.concatenate([np.zeros((1, C), np.float32),
                                    sm[:T - 1]])) / 15.0
    return (base + 2.5 * sm).astype(np.float32)


def _days(y0, y1):
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.xrlite import TimeIndex

    t = np.arange(f"{y0}-01-01", f"{y1 + 1}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    return t, doy, ndoy


def test_percentile_kernel_compiled_matches_xla():
    """Compiled Triton percentile kernel == XLA doy_clim (float32) on a
    cell count that is not a power of two, with ties, a constant cell,
    an all-NaN cell and a NaN gap: thresholds bit-equal, means to 1e-6."""
    import jax.numpy as jnp

    from xmhw_tpu.core.calendar import build_window_index, build_window_ranges
    from xmhw_tpu.core.clim import doy_clim
    from xmhw_tpu.ops.pallas.doy_quantile import pallas_doy_clim

    _, doy, ndoy = _days(2001, 2004)
    T, C = len(doy), 300
    ts = np.round(_series(T, C), 2)
    ts[100:160, 7] = np.nan
    ts[:, 11] = np.nan
    ts[:, 19] = 3.25
    gidx, _ = build_window_index(doy, 5, ndoy)
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    th0, se0 = doy_clim(jnp.asarray(ts), jnp.asarray(gidx), 90)
    th1, se1 = pallas_doy_clim(jnp.asarray(ts),
                               jnp.asarray(starts.reshape(-1)),
                               jnp.asarray(lens.reshape(-1)),
                               ndoy=ndoy, ny=ny, rmax=rmax)
    np.testing.assert_array_equal(np.asarray(th1), np.asarray(th0))
    np.testing.assert_allclose(np.asarray(se1), np.asarray(se0),
                               rtol=1e-6, equal_nan=True)
    assert np.isnan(np.asarray(th1)[:, 11]).all()


def test_threshold_gpu_engine_vs_oracle():
    """threshold() on the GPU engine (kernel + feb29 + smoothing) vs the
    float64 oracle, including a land cell and a NaN gap."""
    import xmhw_tpu as xm
    from oracle import clim_oracle
    from xmhw_tpu.core import engine
    from xmhw_tpu.xrlite import Coord, DataArray

    assert engine.device_engine() == "gpu"
    t, doy, ndoy = _days(2001, 2004)
    T, C = len(t), 24
    ts = _series(T, C, seed=1)
    ts[100:140, 7] = np.nan
    ts[:, 3] = np.nan
    da = DataArray(ts.reshape(T, 4, 6), ("time", "lat", "lon"),
                   {"time": Coord(("time",), t),
                    "lat": Coord(("lat",), np.arange(4.0)),
                    "lon": Coord(("lon",), np.arange(6.0))})
    clim = xm.threshold(da)
    th = np.asarray(clim["thresh"].data).reshape(ndoy, C)
    se = np.asarray(clim["seas"].data).reshape(ndoy, C)
    assert np.isnan(th[:, 3]).all()
    for c in (0, 7, 12, C - 1):
        th64, se64 = clim_oracle(ts[:, c].astype(np.float64), doy, ndoy)
        np.testing.assert_allclose(th[:, c], th64, atol=1e-4)
        np.testing.assert_allclose(se[:, c], se64, atol=1e-4)


def test_detect_compiled_full_length_vs_oracle():
    """Compiled float32 detect engine at T=14610 vs the float64 oracle:
    all 31 table properties, at oracle.f32_event_rtol's tolerances."""
    import jax.numpy as jnp
    from oracle import clim_oracle, compare_events, events_oracle

    from xmhw_tpu.core.features_scan import detect_kernel

    _, doy, ndoy = _days(1982, 2021)
    T, C = len(doy), 16
    ts = _series(T, C, seed=3)
    ts[3000:3030, 5] = np.nan
    th = np.empty((ndoy, C), np.float32)
    se = np.empty((ndoy, C), np.float32)
    for c in range(C):
        a, b = clim_oracle(ts[:, c].astype(np.float64), doy, ndoy)
        th[:, c], se[:, c] = a, b
    pos = (doy - 1).astype(np.int32)
    tbl, nev, _ = detect_kernel(jnp.asarray(ts), jnp.asarray(th),
                                jnp.asarray(se), jnp.asarray(pos), K=256)
    tbl = {k: np.asarray(v) for k, v in tbl.items()}
    assert int(np.asarray(nev).max()) <= 256
    checked = 0
    for c in range(C):
        evs = events_oracle(ts[:, c].astype(np.float64),
                            th[pos, c].astype(np.float64),
                            se[pos, c].astype(np.float64))
        checked += compare_events({k: v[:, c] for k, v in tbl.items()},
                                  evs, where=f"cell {c}")
    assert checked > 500


def test_fused_step_runs_compiled():
    """The fused threshold+detect step of the graft entry compiles and
    runs on the card with finite outputs."""
    import jax

    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(np.asarray(out[0])).any()
    assert int(np.asarray(out[4]).sum()) >= 0
