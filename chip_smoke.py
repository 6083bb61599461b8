#!/usr/bin/env python
"""Smoke run of the main path on NVIDIA GPUs: the quickest proof that the
system starts, compiles its kernels and gets the right answer on a card.

    python chip_smoke.py               # one card: phases a, e, b, c, d
    python chip_smoke.py --four-cards  # threshold/detect on 4 cards vs 1

Phases (each prints its results; any failure exits non-zero):

  a  device check, in a child process: JAX's platform must be "gpu";
     prints the card's name and power limit (nvidia-smi)
  e  the on-card tests (``pytest -m gpu``), in a child, before this
     process opens the card
  b  the public API at real size: threshold -> detect -> block_average
     -> mhw_rank on a seeded 40-year daily grid with ~30 % land
  c  the fused device path (core.pipeline.run_fused, the device core of
     stream_run) with stats and ranks: its tables must equal (b)'s
  d  (b) against tests/oracle.py in float64 on sampled cells, and the
     Pallas percentile kernel against the XLA clim_kernel on a full block

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import xmhw_tpu as xm  # noqa: E402  (fails at once outside the repo)

# full size: 40 years of daily data; 160 x 150 cells with 30 % land leave
# ~16.8k ocean cells, i.e. at least four full blocks of the default size
YEARS = (1982, 2021)
GRID = (160, 150)
LAND_FRAC = 0.3
SEED = 3
N_ORACLE_CELLS = 40

# float32 engine vs the float64 oracle, on the same float32 inputs.
# Climatology: the pooled means sum ~450 float32 values near 20-30 degC
# and the 31-day smoothing sums 31 more; both round at ~1e-6 relative,
# so 1e-4 degC bounds them with margin. Event tables: see
# oracle.F32_EVENT_RTOL.
CLIM_ATOL = 1e-4


def log(msg):
    print(msg, flush=True)


def device_info():
    """(platform, device_kind, count) of JAX's default backend, read in a
    child process so this one does not open (and reserve) the card."""
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "[d[0].platform, d[0].device_kind, len(d)]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(f"device query failed: {out.stderr[-2000:]}")
    platform, kind, count = json.loads(out.stdout.strip().splitlines()[-1])
    return platform, kind, count


def card_power():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def run_gpu_tests():
    """Phase e: the tests that carry the ``gpu`` marker, in a child."""
    cmd = [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
           "-p", "no:cacheprovider", os.path.join(REPO, "tests")]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         timeout=900)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout else ""
    log(f"[e] pytest -m gpu: rc={out.returncode} :: {tail}")
    if out.returncode or "skipped" in tail or "passed" not in tail:
        sys.stdout.write(out.stdout[-6000:])
        sys.stderr.write(out.stderr[-3000:])
        raise RuntimeError("on-card tests failed or did not run")


def make_grid():
    """Seeded daily SST-like grid, generated on the default device.

    Seasonal cycle + 15-day smoothed noise + a per-cell offset; land
    cells are all-NaN; ~5 % of ocean cells get one 60-day NaN gap and
    another ~5 % lose 2 % of their days. Returns (time, ts (T, ny, nx)
    float32)."""
    import jax
    import jax.numpy as jnp

    t = np.arange(f"{YEARS[0]}-01-01", f"{YEARS[1] + 1}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ny, nx = GRID
    C = ny * nx
    k_noise, k_off, k_land, k_gap, k_miss = jax.random.split(
        jax.random.PRNGKey(SEED), 5)

    @jax.jit
    def gen():
        day = jnp.arange(T, dtype=jnp.float32)[:, None]
        base = 15.0 + 3.0 * jnp.sin(2 * jnp.pi * day / 365.25)
        noise = jax.random.normal(k_noise, (T + 14, C), jnp.float32)
        sm = sum(noise[k:k + T] for k in range(15)) / 15.0
        off = jax.random.normal(k_off, (1, C), jnp.float32)
        ts = base + 2.5 * sm + off
        land = jax.random.uniform(k_land, (C,)) < LAND_FRAC
        u = jax.random.uniform(k_gap, (C,))
        g0 = (u * 1e4).astype(jnp.int32) % (T - 60)
        rows = jnp.arange(T)[:, None]
        gap = (u < 0.05)[None, :] & (rows >= g0) & (rows < g0 + 60)
        miss = ((u >= 0.05) & (u < 0.10))[None, :] & (
            jax.random.uniform(k_miss, (T, C)) < 0.02)
        ts = jnp.where(gap | miss | land[None, :], jnp.nan, ts)
        return ts.reshape(T, ny, nx)

    return t, np.asarray(gen())


def dataarray(t, ts):
    from xmhw_tpu.xrlite import Coord, DataArray

    ny, nx = ts.shape[1:]
    return DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.arange(ny, dtype=np.float64)),
         "lon": Coord(("lon",), np.arange(nx, dtype=np.float64))},
        {"units": "degree_C"})


def grid_cells(ds_var, ocean):
    """(rows, ny, nx) labeled grid -> (rows, n_ocean) in cell order."""
    a = np.asarray(ds_var.data)
    return a.reshape(a.shape[0], -1)[:, ocean]


def run_api(t, ts, phases=("cold", "warm"), stats=True):
    """Phase b: threshold -> detect [-> block_average -> mhw_rank]
    through the public API, once per phase. Returns (clim, mhw, times)."""
    da = dataarray(t, ts)
    period = [int(str(t[0])[:4]), int(str(t[-1])[:4])]
    times = {}
    for phase in phases:
        t0 = time.perf_counter()
        clim = xm.threshold(da)
        t1 = time.perf_counter()
        mhw = xm.detect(da, clim["thresh"], clim["seas"],
                        events_layout="compact")
        t2 = time.perf_counter()
        times[phase] = {"threshold_s": t1 - t0, "detect_s": t2 - t1}
        if stats:
            block = xm.block_average(mhw, period=period, device=True)
            rank, ret = xm.mhw_rank(mhw)
            times[phase]["stats_rank_s"] = time.perf_counter() - t2
    if not stats:
        return clim, mhw, times
    for name, ds in (("block", block), ("rank", rank), ("return", ret)):
        for k in ds.keys():
            v = np.asarray(ds[k].data)
            if np.issubdtype(v.dtype, np.floating) and not np.isfinite(
                    v).any():
                raise AssertionError(f"{name}.{k} has no finite value")
    return clim, mhw, times


def event_tables(mhw, ocean, t):
    """(b)'s compact event grids as (K, n_ocean) tables keyed like
    detect_kernel's output (time fields back to time indexes)."""
    tbl = {}
    for k in mhw.keys():
        if mhw[k].dims[0] != "ev":
            continue
        v = grid_cells(mhw[k], ocean)
        if k.startswith("time_"):
            v = np.where(np.isnat(v), -1,
                         np.searchsorted(t, v)).astype(np.int32)
        tbl[k] = v
    return tbl


def run_fused_path(t, ts, ocean):
    """Phase c: core.pipeline.run_fused with year-block stats and ranks on
    the ocean cells. Returns (th, se, tables, n_events, extras, seconds)."""
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.core.features_scan import RANK_VARS
    from xmhw_tpu.core.pipeline import run_fused
    from xmhw_tpu.core.stats import day_block_edges
    from xmhw_tpu.xrlite import TimeIndex

    T = ts.shape[0]
    flat = np.ascontiguousarray(ts.reshape(T, -1)[:, ocean])
    doy, ndoy = compute_doy(TimeIndex(t))
    years = t.astype("datetime64[Y]").astype(np.int64) + 1970
    bins = np.arange(years[0], years[-1] + 2)
    ybod = (np.searchsorted(bins, years, side="right") - 1).astype(np.int32)
    t0 = time.perf_counter()
    out = run_fused(flat, doy, (doy - 1).astype(np.int32), ndoy=ndoy,
                    ybod_np=ybod, nbins=len(bins) - 1,
                    day_edges=day_block_edges(years, bins),
                    rank_names=RANK_VARS)
    return (*out, time.perf_counter() - t0)


def check_fused_equal(clim, mhw_tbl, fused, ocean):
    """(c)'s climatology and tables equal (b)'s bit for bit."""
    th, se, tables, nev, extras, _ = fused
    np.testing.assert_array_equal(grid_cells(clim["thresh"], ocean), th)
    np.testing.assert_array_equal(grid_cells(clim["seas"], ocean), se)
    kmax = next(iter(mhw_tbl.values())).shape[0]
    assert int(nev.max()) == kmax, (int(nev.max()), kmax)
    for k, v in mhw_tbl.items():
        np.testing.assert_array_equal(tables[k][:kmax], v, err_msg=k)
    for part in ("block", "day", "rank"):
        for k, v in extras[part].items():
            assert np.isfinite(v).any(), f"{part}.{k} has no finite value"


def oracle_cells(ts, ocean, n=N_ORACLE_CELLS):
    """Sampled ocean cells (positions in the ocean-cell order): every
    gap-holed kind, the first and last ocean cell, and random others."""
    T = ts.shape[0]
    flat = ts.reshape(T, -1)[:, ocean]
    nan_days = np.isnan(flat).sum(axis=0)
    rng = np.random.default_rng(SEED)
    gapped = np.nonzero(nan_days >= 60)[0]
    sparse = np.nonzero((nan_days > 0) & (nan_days < 60))[0]
    pick = [0, flat.shape[1] - 1]
    pick += list(rng.choice(gapped, min(8, len(gapped)), replace=False))
    pick += list(rng.choice(sparse, min(8, len(sparse)), replace=False))
    rest = np.setdiff1d(np.arange(flat.shape[1]), pick)
    pick += list(rng.choice(rest, n - len(pick), replace=False))
    return np.asarray(sorted(set(int(c) for c in pick)))


def check_vs_oracle(t, ts, ocean, clim, mhw_tbl, cells):
    """Phase d: climatology and every event property of the sampled cells
    against tests/oracle.py in float64. Returns (events checked, worst
    climatology error in degC)."""
    from oracle import clim_oracle, compare_events, events_oracle
    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.xrlite import TimeIndex

    T = ts.shape[0]
    flat = ts.reshape(T, -1)[:, ocean].astype(np.float64)
    doy, ndoy = compute_doy(TimeIndex(t))
    th = grid_cells(clim["thresh"], ocean).astype(np.float64)
    se = grid_cells(clim["seas"], ocean).astype(np.float64)
    land = ~ocean
    for name in ("thresh", "seas"):
        g = np.asarray(clim[name].data).reshape(ndoy, -1)[:, land]
        assert np.isnan(g).all(), f"land cells must stay NaN in {name}"
    worst = 0.0
    checked = 0
    for c in cells:
        th_o, se_o = clim_oracle(flat[:, c], doy, ndoy)
        for got, want in ((th[:, c], th_o), (se[:, c], se_o)):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            fin = np.isfinite(want)
            err = float(np.max(np.abs(got[fin] - want[fin]), initial=0))
            worst = max(worst, err)
            assert err <= CLIM_ATOL, (c, err)
        evs = events_oracle(flat[:, c], th[doy - 1, c], se[doy - 1, c])
        col = {k: v[:, c] for k, v in mhw_tbl.items()}
        checked += compare_events(col, evs, where=f"cell {c}")
    return checked, worst


def timed(fn, *args, reps=5):
    """Warm seconds per call of a jitted fn (compiled first), ending in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def kernel_vs_xla(ts, ocean, t, block):
    """Phase d, second half: the Pallas percentile kernel against the XLA
    clim_kernel's float32 path on one full block — pooled thresholds
    bit-equal, seas within 1e-6 relative — with both warm times."""
    import jax.numpy as jnp

    from xmhw_tpu.core.calendar import (build_window_index,
                                        build_window_ranges, compute_doy)
    from xmhw_tpu.core.clim import doy_clim
    from xmhw_tpu.ops.pallas import doy_quantile
    from xmhw_tpu.xrlite import TimeIndex

    T = ts.shape[0]
    x = jnp.asarray(ts.reshape(T, -1)[:, ocean][:, :block])
    doy, ndoy = compute_doy(TimeIndex(t))
    gidx = jnp.asarray(build_window_index(doy, 5, ndoy)[0])
    starts, lens, ny, rmax = build_window_ranges(doy, 5, ndoy)
    s = jnp.asarray(starts.reshape(-1))
    ln = jnp.asarray(lens.reshape(-1))

    def kern(a):
        return doy_quantile.pallas_doy_clim(
            a, s, ln, ndoy=ndoy, ny=ny, rmax=rmax,
            interpret=doy_quantile.INTERPRET)

    def xla(a):
        return doy_clim(a, gidx, 90)

    th_k, se_k = (np.asarray(v) for v in kern(x))
    th_x, se_x = (np.asarray(v) for v in xla(x))
    np.testing.assert_array_equal(th_k, th_x)
    np.testing.assert_allclose(se_k, se_x, rtol=1e-6, equal_nan=True)
    return {"kernel_s": timed(kern, x), "xla_s": timed(xla, x),
            "block": int(x.shape[1])}


def detect_split(t, ts, ocean, clim, block):
    """Warm seconds of one detect_kernel step on a full block (the XLA
    detect stage a future kernel must beat), and of run_detect (device
    path incl. transfers) against the whole detect() call."""
    import jax
    import jax.numpy as jnp

    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.core.features_scan import detect_kernel
    from xmhw_tpu.core.pipeline import run_detect
    from xmhw_tpu.xrlite import TimeIndex

    T = ts.shape[0]
    flat = np.ascontiguousarray(ts.reshape(T, -1)[:, ocean])
    th = np.ascontiguousarray(grid_cells(clim["thresh"], ocean))
    se = np.ascontiguousarray(grid_cells(clim["seas"], ocean))
    doy, _ = compute_doy(TimeIndex(t))
    pos = (doy - 1).astype(np.int32)
    args = [jnp.asarray(a[:, :block]) for a in (flat, th, se)]
    out = {"detect_step_s": timed(lambda *a: detect_kernel(*a, K=128),
                                  *args, jnp.asarray(pos))}
    run_detect(flat, th, se, pos, 5, True, 2)
    t0 = time.perf_counter()
    run_detect(flat, th, se, pos, 5, True, 2)
    out["run_detect_s"] = time.perf_counter() - t0
    da = dataarray(t, ts)
    t0 = time.perf_counter()
    xm.detect(da, clim["thresh"], clim["seas"], events_layout="compact")
    out["detect_api_s"] = time.perf_counter() - t0
    return out


def threshold_by_engine(t, ts):
    """Warm end-to-end threshold() on the smoke grid with each engine
    (the GPU engine's Pallas kernel, and the plain XLA engine)."""
    from xmhw_tpu.core import engine

    da = dataarray(t, ts)
    out = {}
    real = engine.device_engine
    try:
        for name in ("gpu", "cpu"):
            engine.device_engine = lambda n=name: n
            xm.threshold(da)
            t0 = time.perf_counter()
            xm.threshold(da)
            out[f"threshold_{name}_engine_s"] = time.perf_counter() - t0
    finally:
        engine.device_engine = real
    return out


def detect_memory(ts, ocean, t, block):
    """compiled.memory_analysis() of one detect step at the runner's
    block size."""
    import jax
    import jax.numpy as jnp

    from xmhw_tpu.core.calendar import compute_doy
    from xmhw_tpu.core.features_scan import detect_kernel
    from xmhw_tpu.xrlite import TimeIndex

    T = ts.shape[0]
    doy, ndoy = compute_doy(TimeIndex(t))
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((T, block), f32),
            jax.ShapeDtypeStruct((ndoy, block), f32),
            jax.ShapeDtypeStruct((ndoy, block), f32),
            jnp.asarray((doy - 1).astype(np.int32)))
    ma = detect_kernel.lower(*args, K=128).compile().memory_analysis()
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes") if hasattr(ma, k)}


def one_card():
    import jax

    from xmhw_tpu.core.pipeline import CellRunner

    t0 = time.perf_counter()
    t, ts = make_grid()
    T, ny, nx = ts.shape
    ocean = ~np.isnan(ts).all(axis=0).reshape(-1)
    log(f"[b] grid T={T} {ny}x{nx}, ocean cells {int(ocean.sum())}, "
        f"made in {time.perf_counter() - t0:.2f} s")

    clim, mhw, times = run_api(t, ts)
    mhw_tbl = event_tables(mhw, ocean, t)
    n_ev = int(np.isfinite(mhw_tbl["event"]).sum())
    log(f"[b] events {n_ev}; times (s): {json.dumps(times)}")
    block = CellRunner(int(ocean.sum()), T, 11, 366).block
    log(f"[b] block {block}; detect step memory_analysis: "
        f"{json.dumps(detect_memory(ts, ocean, t, block))}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[b] peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    fused = run_fused_path(t, ts, ocean)
    check_fused_equal(clim, mhw_tbl, fused, ocean)
    log(f"[c] run_fused with stats+ranks: {fused[-1]:.3f} s; "
        "climatology and tables equal (b)")

    cells = oracle_cells(ts, ocean)
    t0 = time.perf_counter()
    checked, worst = check_vs_oracle(t, ts, ocean, clim, mhw_tbl, cells)
    log(f"[d] oracle: {len(cells)} cells, {checked} events, all 31 "
        f"properties in tolerance; worst clim error {worst:.3e} degC "
        f"(limit {CLIM_ATOL}); {time.perf_counter() - t0:.1f} s")
    kx = kernel_vs_xla(ts, ocean, t, block)
    log(f"[d] percentile kernel vs XLA clim (block {kx['block']}): "
        f"thresh bit-equal, seas rtol 1e-6; kernel {kx['kernel_s']:.6f} s"
        f", xla {kx['xla_s']:.6f} s")
    log(f"[d] threshold() warm by engine: "
        f"{json.dumps(threshold_by_engine(t, ts))}")
    log(f"[d] detect warm (block {block}): "
        f"{json.dumps(detect_split(t, ts, ocean, clim, block))}")


def four_cards():
    """threshold()/detect() sharded over four cards (the API shards cells
    over every visible device); compared with the same run on one card,
    made first in a child that sees only card 0."""
    import jax

    n = len(jax.devices())
    if n != 4:
        raise RuntimeError(f"--four-cards needs 4 visible cards, got {n}")
    t, ts = make_grid()
    ocean = ~np.isnan(ts).all(axis=0).reshape(-1)
    clim, mhw, times = run_api(t, ts, phases=("cold",), stats=False)
    log(f"[4] threshold+detect on {n} cards (s, cold): "
        f"{json.dumps(times['cold'])}")
    return {"thresh": grid_cells(clim["thresh"], ocean),
            "seas": grid_cells(clim["seas"], ocean),
            **event_tables(mhw, ocean, t)}


def _one_card_reference(path):
    """Child side of --four-cards: the one-card run, saved to ``path``."""
    t, ts = make_grid()
    ocean = ~np.isnan(ts).all(axis=0).reshape(-1)
    clim, mhw, times = run_api(t, ts, phases=("cold",), stats=False)
    print(f"[4] threshold+detect on 1 card (s, cold): "
          f"{json.dumps(times['cold'])}", flush=True)
    np.savez(path, thresh=grid_cells(clim["thresh"], ocean),
             seas=grid_cells(clim["seas"], ocean),
             **event_tables(mhw, ocean, t))


def compare_four(got, ref):
    """Integer fields equal; float fields within 1e-6 relative (each cell
    runs the same program on its own card; only XLA's per-shape kernel
    choices may differ)."""
    for k in ref.files:
        a, b = got[k], ref[k]
        if k in ("thresh", "seas") or np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), k)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    return len(ref.files)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and its one-card "
                         "comparison")
    ap.add_argument("--reference-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.reference_out:
        _one_card_reference(args.reference_out)
        return 0
    try:
        platform, kind, count = device_info()
        if platform != "gpu":
            print(f"chip_smoke: needs an NVIDIA GPU; JAX's platform is "
                  f"{platform!r}", file=sys.stderr)
            return 2
        log(f"[a] platform {platform}, {kind} x {count}")
        log(card_power())
        if args.four_cards:
            import tempfile

            with tempfile.TemporaryDirectory() as d:
                ref_path = os.path.join(d, "one_card.npz")
                t0 = time.perf_counter()
                subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--reference-out", ref_path],
                    env={**os.environ, "CUDA_VISIBLE_DEVICES": "0"},
                    check=True,
                    timeout=900)
                log(f"[4] one-card reference run: "
                    f"{time.perf_counter() - t0:.2f} s in all (child, "
                    f"card 0)")
                got = four_cards()
                n = compare_four(got, np.load(ref_path))
            log(f"[4] {n} fields: four cards == one card")
        else:
            run_gpu_tests()
            one_card()
        import jax

        d = jax.devices()
        if d[0].platform != "gpu":
            raise RuntimeError(f"platform changed to {d[0].platform}")
    except Exception as e:  # every phase's failure is the script's
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
