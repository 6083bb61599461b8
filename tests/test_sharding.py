"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The pipeline is embarrassingly parallel over cells (SURVEY §2.6/§5): these
tests verify that sharding the cell axis over a Mesh produces bitwise the
same results as single-device execution, and that the sharded program
compiles and runs under jit with NamedSharding inputs.
"""

import jax
import numpy as np
import pytest

import xmhw_tpu as xm
from xmhw_tpu.parallel import cell_mesh, cell_sharding, pad_cells


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_threshold_mesh_matches_single(oisst_ts):
    mesh = cell_mesh()
    a = xm.threshold(oisst_ts, dtype=np.float64)
    b = xm.threshold(oisst_ts, dtype=np.float64, mesh=mesh)
    np.testing.assert_array_equal(np.nan_to_num(a["thresh"].data),
                                  np.nan_to_num(b["thresh"].data))
    np.testing.assert_array_equal(np.nan_to_num(a["seas"].data),
                                  np.nan_to_num(b["seas"].data))


def test_detect_mesh_matches_single(oisst_ts):
    mesh = cell_mesh()
    clim = xm.threshold(oisst_ts, dtype=np.float64)
    a = xm.detect(oisst_ts, clim["thresh"], clim["seas"], dtype=np.float64)
    b = xm.detect(oisst_ts, clim["thresh"], clim["seas"], dtype=np.float64,
                  mesh=mesh)
    for v in ("event", "duration", "intensity_max", "rate_onset",
              "severity_cumulative"):
        np.testing.assert_array_equal(np.nan_to_num(a[v].data),
                                      np.nan_to_num(b[v].data))


def test_sharded_kernel_placement():
    """Arrays land sharded over the mesh and the kernel consumes them."""
    import jax.numpy as jnp

    from xmhw_tpu.core.events import mhw_filter

    mesh = cell_mesh()
    T, C = 64, 16
    rng = np.random.default_rng(0)
    b = rng.random((T, C)) > 0.4
    x = jax.device_put(jnp.asarray(b), cell_sharding(mesh, 2))
    assert len(x.sharding.device_set) == 8
    out = mhw_filter(x, min_duration=5)
    # output keeps the cell axis sharded; no gather happened on device
    assert len(out["event_id"].sharding.device_set) == 8
    ref = mhw_filter(jnp.asarray(b), min_duration=5)
    np.testing.assert_array_equal(np.asarray(out["event_id"]),
                                  np.asarray(ref["event_id"]))


def test_pad_cells():
    arr = np.ones((4, 10))
    padded, n = pad_cells(arr, 8)
    assert padded.shape == (4, 16) and n == 10
    assert np.isnan(padded[:, 10:]).all()
    same, n2 = pad_cells(arr, 5)
    assert same.shape == (4, 10)


def test_pallas_clim_under_shard_map(monkeypatch):
    """The GPU engine's percentile kernel wrapped in shard_map over the
    8-device mesh (interpret mode) matches the XLA path — exercises the
    multi-card code branch of run_clim."""
    import xmhw_tpu.core.pipeline as P
    from xmhw_tpu.core import engine
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.ops.pallas import doy_quantile
    from xmhw_tpu.xrlite import TimeIndex

    rng = np.random.default_rng(0)
    t = np.arange("2001-01-01", "2004-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    ts = np.round(rng.normal(15, 3, (len(t), 300)), 2).astype(np.float32)
    th_x, se_x = P.run_clim(ts, doy, 5, ndoy, 90, True, 31, True)
    monkeypatch.setattr(engine, "device_engine", lambda: "gpu")
    monkeypatch.setattr(doy_quantile, "INTERPRET", True)
    th_p, se_p = P.run_clim(ts, doy, 5, ndoy, 90, True, 31, True,
                            mesh=cell_mesh(), block=256)
    np.testing.assert_array_equal(th_p, th_x)
    np.testing.assert_allclose(se_p, se_x, atol=1e-5, equal_nan=True)


@pytest.mark.slow
def test_run_fused_mesh_matches_single():
    """The fused single-pass engine (clim+detect+stats+rank) under the
    8-device mesh matches its single-device outputs — XLA branch
    (auto-partition) and the exact stats-kernel sharding stream_run
    uses."""
    import xmhw_tpu.core.pipeline as P
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.core.stats import day_block_edges
    from xmhw_tpu.xrlite import TimeIndex

    rng = np.random.default_rng(5)
    t = np.arange("2001-01-01", "2004-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ti = TimeIndex(t)
    doy, ndoy = compute_doy(ti)
    doy_pos = (doy - 1).astype(np.int32)
    C = 64
    ts = np.round(rng.normal(15, 3, (T, C)), 2).astype(np.float64)
    years = np.asarray(ti.year)
    bins = np.arange(years[0], years[-1] + 2)
    nbins = len(bins) - 1
    ybod = (np.searchsorted(bins, years, side="right") - 1).astype(
        np.int32)
    edges = day_block_edges(years, bins)
    kw = dict(w=5, ndoy=ndoy, ybod_np=ybod, nbins=nbins,
              day_edges=edges, rank_names=("intensity_max", "duration"))
    a = P.run_fused(ts, doy, doy_pos, **kw)
    b = P.run_fused(ts, doy, doy_pos, mesh=cell_mesh(), block=32, **kw)
    np.testing.assert_array_equal(np.nan_to_num(a[0]),
                                  np.nan_to_num(b[0]))
    np.testing.assert_array_equal(a[3], b[3])
    for k in a[2]:
        np.testing.assert_array_equal(np.nan_to_num(a[2][k], nan=-9),
                                      np.nan_to_num(b[2][k], nan=-9),
                                      err_msg=k)
    for part in ("block", "day", "rank"):
        for k in a[4][part]:
            np.testing.assert_allclose(a[4][part][k], b[4][part][k],
                                       atol=1e-12, equal_nan=True,
                                       err_msg=f"{part}/{k}")


@pytest.mark.slow
def test_run_fused_pallas_under_shard_map(monkeypatch):
    """run_fused's GPU-engine climatology (percentile kernel, interpret
    mode) under the 8-device mesh matches the XLA single-device path."""
    import xmhw_tpu.core.pipeline as P
    from xmhw_tpu.core import engine
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.ops.pallas import doy_quantile
    from xmhw_tpu.xrlite import TimeIndex

    rng = np.random.default_rng(6)
    t = np.arange("2001-01-01", "2003-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    doy_pos = (doy - 1).astype(np.int32)
    C = 1024
    ts = np.round(rng.normal(15, 3, (len(t), C)), 2).astype(np.float32)
    a = P.run_fused(ts, doy, doy_pos, w=5, ndoy=ndoy)
    monkeypatch.setattr(engine, "device_engine", lambda: "gpu")
    monkeypatch.setattr(doy_quantile, "INTERPRET", True)
    b = P.run_fused(ts, doy, doy_pos, w=5, ndoy=ndoy, mesh=cell_mesh(),
                    block=512)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[3], b[3])
    for v in ("event", "duration", "time_start"):
        np.testing.assert_array_equal(
            np.nan_to_num(a[2][v], nan=-9),
            np.nan_to_num(b[2][v], nan=-9), err_msg=v)
    for v in ("intensity_max", "rate_onset"):
        np.testing.assert_allclose(a[2][v], b[2][v], atol=2e-4,
                                   rtol=2e-4, equal_nan=True, err_msg=v)
