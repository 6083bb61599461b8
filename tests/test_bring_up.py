"""CPU tests of what the GPU bring-up rests on: the float32 engine's
accuracy at full record length, the absence of matrix products (no TF32
exposure) in the detect program, the compile-cache rule, bench.py's
refusal to run without a GPU, and chip_smoke.py's phases at a tiny size."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import clim_oracle, compare_events, events_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _days(y0, y1):
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.xrlite import TimeIndex

    t = np.arange(f"{y0}-01-01", f"{y1 + 1}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    doy, ndoy = compute_doy(TimeIndex(t))
    return t, doy, ndoy


def _series(T, C, seed):
    rng = np.random.default_rng(seed)
    day = np.arange(T)[:, None]
    noise = rng.normal(0, 1, (T + 14, C)).astype(np.float32)
    cs = np.cumsum(noise, axis=0, dtype=np.float64)
    sm = (cs[14:] - np.concatenate([np.zeros((1, C)), cs[:T - 1]])) / 15
    return (15 + 3 * np.sin(2 * np.pi * day / 365.25) + 2.5 * sm
            + rng.normal(0, 0.5, (1, C))).astype(np.float32)


@pytest.mark.parametrize("md,mg,join", [(5, 2, True), (3, 1, False)])
def test_f32_engine_full_length_vs_oracle(md, mg, join):
    """float32 detect at T=14610 vs the float64 oracle: all 31 table
    properties within oracle.f32_event_rtol (a prefix-sum engine misses
    intensity_var_abs by ~1e-2 relative here)."""
    from xmhw_tpu.core.features_scan import TABLE_VARS, detect_kernel

    _, doy, ndoy = _days(1982, 2021)
    T, C = len(doy), 5
    ts = _series(T, C, seed=3)
    ts[4000:4060, 2] = np.nan
    th = np.empty((ndoy, C), np.float32)
    se = np.empty((ndoy, C), np.float32)
    for c in range(C):
        a, b = clim_oracle(ts[:, c].astype(np.float64), doy, ndoy)
        th[:, c], se[:, c] = a, b
    pos = (doy - 1).astype(np.int32)
    tbl, nev, _ = detect_kernel(
        jnp.asarray(ts), jnp.asarray(th), jnp.asarray(se),
        jnp.asarray(pos), K=256, min_duration=md, join_gaps=join,
        max_gap=mg)
    tbl = {k: np.asarray(v) for k, v in tbl.items()}
    assert set(tbl) == set(TABLE_VARS) and len(TABLE_VARS) == 31
    assert tbl["intensity_var_abs"].dtype == np.float32
    checked = 0
    for c in range(C):
        evs = events_oracle(ts[:, c].astype(np.float64),
                            th[pos, c].astype(np.float64),
                            se[pos, c].astype(np.float64), md, join, mg)
        checked += compare_events({k: v[:, c] for k, v in tbl.items()},
                                  evs, where=f"cell {c}")
    assert checked > 150


def test_detect_program_has_no_matrix_product():
    """The float32 detect program holds no dot: its sums are segmented
    scan adds, so no matmul precision (TF32 on a GPU) can round them."""
    from xmhw_tpu.core.features_scan import detect_kernel

    T, C = 400, 8
    f32 = jnp.float32
    hlo = detect_kernel.lower(
        jax.ShapeDtypeStruct((T, C), f32), jax.ShapeDtypeStruct((366, C), f32),
        jax.ShapeDtypeStruct((366, C), f32),
        jax.ShapeDtypeStruct((T,), jnp.int32), K=16).as_text()
    assert "dot_general" not in hlo and "stablehlo.dot" not in hlo


@pytest.mark.parametrize("env,expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/where"}, "/some/where"),
    ({}, "default"),
])
def test_compile_cache_dir_rule(monkeypatch, env, expect):
    """JAX_COMPILATION_CACHE_DIR wins; else a fixed path in the checkout."""
    import xmhw_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = (xmhw_tpu.DEFAULT_CACHE_DIR if expect == "default" else expect)
    assert xmhw_tpu.compile_cache_dir() == want
    assert xmhw_tpu.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_compile_cache_env_sets_no_path_in_code(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the package sets no cache path
    of its own (JAX reads the variable itself)."""
    import xmhw_tpu

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    # an accelerator process (the variable is read at import, long past)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.delenv("XMHW_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    xmhw_tpu._enable_compile_cache()
    assert "jax_compilation_cache_dir" not in dict(calls)
    calls.clear()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    xmhw_tpu._enable_compile_cache()
    assert dict(calls)["jax_compilation_cache_dir"] == \
        xmhw_tpu.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("opt_out", [False, True])
def test_kcache_follows_cache_dir(monkeypatch, tmp_path, opt_out):
    from xmhw_tpu import stream

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    if opt_out:
        monkeypatch.setenv("XMHW_COMPILE_CACHE", "0")
        assert stream._kcache_file() is None
    else:
        monkeypatch.delenv("XMHW_COMPILE_CACHE", raising=False)
        assert stream._kcache_file() == str(tmp_path / "kcache.json")


def test_bench_refuses_cpu(monkeypatch):
    """bench.py measures the card only: no GPU -> non-zero exit."""
    sys.path.insert(0, REPO)
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0


# ---- chip_smoke.py at a tiny size ----------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    sys.path.insert(0, REPO)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "YEARS", (2001, 2003))
    monkeypatch.setattr(chip_smoke, "GRID", (6, 7))
    return chip_smoke


@pytest.fixture
def smoke_run(smoke):
    t, ts = smoke.make_grid()
    ocean = ~np.isnan(ts).all(axis=0).reshape(-1)
    clim, mhw, times = smoke.run_api(t, ts)
    return t, ts, ocean, clim, mhw, times


def test_chip_smoke_grid(smoke):
    """Seeded, land all-NaN, some ocean cells holed, reproducible."""
    t, ts = smoke.make_grid()
    assert ts.shape == (len(t), 6, 7) and ts.dtype == np.float32
    flat = ts.reshape(len(t), -1)
    land = np.isnan(flat).all(axis=0)
    assert 0 < land.sum() < flat.shape[1]
    np.testing.assert_array_equal(ts, smoke.make_grid()[1])


def test_chip_smoke_api_and_fused_agree(smoke, smoke_run):
    t, ts, ocean, clim, mhw, times = smoke_run
    assert set(times) == {"cold", "warm"}
    tbl = smoke.event_tables(mhw, ocean, t)
    assert np.isfinite(tbl["event"]).sum() > 0
    fused = smoke.run_fused_path(t, ts, ocean)
    smoke.check_fused_equal(clim, tbl, fused, ocean)


def test_chip_smoke_oracle_phase(smoke, smoke_run):
    t, ts, ocean, clim, mhw, _ = smoke_run
    tbl = smoke.event_tables(mhw, ocean, t)
    cells = smoke.oracle_cells(ts, ocean, n=10)
    checked, worst = smoke.check_vs_oracle(t, ts, ocean, clim, tbl, cells)
    assert checked > 0 and worst <= smoke.CLIM_ATOL


def test_chip_smoke_kernel_phase(smoke, monkeypatch):
    from xmhw_tpu.ops.pallas import doy_quantile

    monkeypatch.setattr(doy_quantile, "INTERPRET", True)
    t, ts = smoke.make_grid()
    ocean = ~np.isnan(ts).all(axis=0).reshape(-1)
    out = smoke.kernel_vs_xla(ts, ocean, t, 16)
    assert out["block"] == 16 and out["kernel_s"] > 0


def test_chip_smoke_detect_split(smoke, smoke_run):
    t, ts, ocean, clim, mhw, _ = smoke_run
    out = smoke.detect_split(t, ts, ocean, clim, 8)
    assert set(out) == {"detect_step_s", "run_detect_s", "detect_api_s"}


def test_chip_smoke_four_card_compare(smoke, smoke_run, tmp_path):
    t, ts, ocean, clim, mhw, _ = smoke_run
    got = {"thresh": smoke.grid_cells(clim["thresh"], ocean),
           "seas": smoke.grid_cells(clim["seas"], ocean),
           **smoke.event_tables(mhw, ocean, t)}
    np.savez(tmp_path / "ref.npz", **got)
    assert smoke.compare_four(got, np.load(tmp_path / "ref.npz")) == 33
    got["duration"] = got["duration"] + 1
    with pytest.raises(AssertionError):
        smoke.compare_four(got, np.load(tmp_path / "ref.npz"))


def test_chip_smoke_main_fails_on_cpu(smoke, monkeypatch, capsys):
    """No GPU -> non-zero exit and no result line."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
