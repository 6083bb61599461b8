#!/usr/bin/env python
"""Benchmark suite: the BASELINE.md configs on an NVIDIA GPU.

Headline metric (stdout JSON line): grid-cells/sec per card for the
fused threshold+detect step at GLOBAL scale — every block of a
620k-ocean-cell x 40-year grid is actually executed on the card (not
extrapolated from a few blocks). Without a GPU the bench exits non-zero;
so does a failed config. Every result names the device and the card's
power limit.

The final stdout line is SHORT (metric/value/unit/device/card); the full
config suite (BASELINE.md "configs to implement") is written to
bench_detail.json (next to this file) and traced on stderr:

  0 global_streamed   MEASURED file-to-file planet-scale pipeline:
                      stream_threshold/detect/block_average/rank on a
                      multi-GB synthetic NetCDF on disk (wall, RSS,
                      device share; scale via XMHW_BENCH_GLOBAL), plus
                      the fused single-pass stream_run (one read + one
                      upload for all four stages) on the same file
  1 single_point      ~30-yr series through the public API (host incl.)
  2 tasman_regional   50x50 grid, 30% land NaNs, union assembly
                      included (user-visible end-to-end), upload share
                      reported separately (skipna=True is vacuous by
                      design — not separately benched)
  3 global_fused      device-resident fused kernel over all 152 blocks
                      (K-overflow asserted against raw counts)
  4 monthly_tstep     non-daily tstep path through the public API
  5 stats_pipeline    detect(compact) + block_average(device) + mhw_rank

Execution order differs from the numbering: global_fused runs first
(secures the headline rate within minutes on a warm compile cache),
global_streamed last (it resets the kernel peak-RSS watermark on entry
so its RSS is its own, and it degrades to a smaller cached grid when
the remaining budget is short). If the process is signalled or exceeds
XMHW_BENCH_BUDGET_S (default 2400 s), the detail is written with every
config measured so far and the bench exits non-zero.
XMHW_BENCH_TRACE=dir additionally captures a jax.profiler trace of one
warm fused step.

For global_fused, synthetic data is generated on-device (seasonal cycle
+ AR-smoothed noise), so the step measures the device engine; the
streamed config 0 measures the host<->device path deliberately.
"""

import json
import os
import sys
import time

import numpy as np

FAST = bool(os.environ.get("XMHW_BENCH_FAST"))

# wall-clock deadline (set by main from XMHW_BENCH_BUDGET_S): configs
# that can scale (global_streamed) size themselves to the REMAINING
# budget instead of being killed mid-run by the harness timeout
_DEADLINE = None


def _remaining():
    return (float("inf") if _DEADLINE is None
            else _DEADLINE - time.monotonic())


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _reset_peak_rss():
    """Reset the kernel's peak-RSS watermark (VmHWM) for this process,
    so a config measured late in the suite reports its own peak rather
    than an earlier config's. Linux-only; no-op where unsupported."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


def _peak_rss_gb():
    """Peak host RSS in GB: VmHWM (resettable via _reset_peak_rss)
    when available, ru_maxrss otherwise."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _host_series(T, ny, nx, land_frac=0.3, seed=1):
    rng = np.random.default_rng(seed)
    day = np.arange(T, dtype=np.float32)[:, None, None]
    base = 15 + 3 * np.sin(2 * np.pi * day / 365.25)
    noise = rng.normal(0, 1.0, (T + 14, ny, nx)).astype(np.float32)
    sm = np.stack([noise[k:k + T] for k in range(15)]).mean(0)
    ts = (base + 2.5 * sm).astype(np.float32)
    land = rng.random((ny, nx)) < land_frac
    ts[:, land] = np.nan
    return ts


def _dataarray(ts, t):
    from xmhw_tpu.xrlite import Coord, DataArray

    ny, nx = ts.shape[1:]
    return DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.linspace(-45, -33, ny)),
         "lon": Coord(("lon",), np.linspace(147, 159, nx))},
        {"units": "degree_C"})


def bench_global_fused():
    """Config 3: fused threshold+detect over a full global grid's worth
    of device-resident blocks (620k ocean cells, 40 years)."""
    import jax
    import jax.numpy as jnp

    from xmhw_tpu.core.calendar import build_window_index, compute_doy
    from xmhw_tpu.core.clim import clim_kernel
    from xmhw_tpu.core.features_scan import detect_kernel
    from xmhw_tpu.core.pipeline import (_kernel_clim_block,
                                        _kernel_clim_tables)
    from xmhw_tpu.xrlite import TimeIndex

    t = np.arange("1982-01-01", "2022-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    doy, ndoy = compute_doy(TimeIndex(t))
    # the engine's climatology: the percentile kernel on the GPU engine
    tables = _kernel_clim_tables(np.dtype(np.float32), doy, 5, ndoy)
    C = 256 if FAST else 4096
    K = 128
    GLOBAL_CELLS = 620_000
    n_blocks = 2 if FAST else -(-GLOBAL_CELLS // C)  # 152

    doy_pos = jnp.asarray((doy - 1).astype(np.int32))
    if tables is None:
        gidx = jnp.asarray(build_window_index(doy, 5, ndoy)[0])
    else:
        starts_np, lens_np, ny, rmax = tables
        starts = jnp.asarray(starts_np.reshape(-1))
        lens = jnp.asarray(lens_np.reshape(-1))

    @jax.jit
    def gen(key):
        day = jnp.arange(T, dtype=jnp.float32)[:, None]
        base = 15 + 3 * jnp.sin(2 * jnp.pi * day / 365.25)
        noise = jax.random.normal(key, (T, C), jnp.float32)
        sm = sum(jnp.roll(noise, k, 0) for k in range(-7, 8)) / 15.0
        return base + 2.5 * sm

    def _core(ts):
        if tables is None:
            th, se = clim_kernel(ts, gidx)
        else:
            th, se = _kernel_clim_block(
                ts, starts, lens, ndoy=ndoy, ny=ny, rmax=rmax,
                pctile=90, smooth=True, smooth_w=31, patch_feb29=True)
        return detect_kernel(ts, th, se, doy_pos, K=K)

    def _step1(ts):
        table, nev, _ = _core(ts)
        digest = jnp.stack(
            [jnp.nansum(v.astype(jnp.float32)) for v in table.values()])
        # max raw count rides the digest so the host can assert K was
        # never overflowed (raw counts may exceed K; a silent overflow
        # would truncate events out of the digest)
        return digest, jnp.sum(nev), jnp.max(nev)

    step = jax.jit(_step1)

    # BASELINE config 5 at global scale: the full device-resident stats
    # pipeline chained on the fused step — year-block aggregations
    # (block_average device kernel) + ordinal ranks/return periods for
    # every ranked property, nothing leaving the card but a digest
    from xmhw_tpu.core.stats import (EVENT_VARS, binned_event_stats,
                                     rank_events_desc)

    year_of = jnp.asarray(
        (t.astype("datetime64[Y]").astype(np.int64)
         - t[0].astype("datetime64[Y]").astype(np.int64)).astype(np.int32))
    n_years = int(np.asarray(year_of).max()) + 1

    def _step_stats1(ts):
        table, nev, _ = _core(ts)
        tstart = table["time_start"]
        valid = tstart >= 0
        bins = year_of[jnp.clip(tstart, 0, T - 1)]
        vals = jnp.stack([table[k].astype(jnp.float32)
                          for k in EVENT_VARS])
        blk = binned_event_stats(vals, bins, valid, nbins=n_years)
        ranks = {k: rank_events_desc(table[k].astype(jnp.float32), valid)
                 for k in ("intensity_max", "duration",
                           "intensity_cumulative", "severity_mean",
                           "rate_onset")}
        digest = (jnp.stack([jnp.nansum(v) for v in blk.values()]).sum()
                  + jnp.stack([jnp.nansum((n_years + 1.0) / r)
                               for r in ranks.values()]).sum())
        return digest, jnp.sum(nev)

    step_stats = jax.jit(_step_stats1)

    # Pre-stage a handful of distinct device-resident input blocks and
    # round-robin the timed steps over them: the synthetic generator
    # (random normal + 15-day smoothing, ~70 ms/block) is test harness,
    # not framework, so it stays OUTSIDE the timed region. 152 blocks of
    # (T, 4096) f32 would need ~36 GB HBM, hence the rotation.
    #
    # Timing model: the per-block dispatches are issued back-to-back
    # and execute asynchronously, so the loop wall tracks device time.
    ngen = min(4, n_blocks)
    keys = jax.random.split(jax.random.PRNGKey(0), ngen + 1)
    staged = [gen(k) for k in keys[:ngen]]

    # warmup: compile, then a few untimed steps
    digest, nev, nmax = step(staged[-1])
    assert np.isfinite(np.asarray(digest)).all()
    warm_events = int(nev)
    ramp = [step(staged[i % ngen]) for i in range(4)]
    _ = np.asarray(jnp.stack([d for d, _, _ in ramp]).sum(axis=0))

    # XMHW_BENCH_TRACE=dir: capture a jax.profiler trace of ONE warm
    # fused step (threshold+detect, all kernels) — the per-stage
    # attribution evidence behind docs/design.md's measured table
    trace_dir = os.environ.get("XMHW_BENCH_TRACE")
    trace_note = None
    if trace_dir:
        try:
            with jax.profiler.trace(trace_dir):
                d, _, _ = step(staged[0])
                _ = float(jnp.sum(d))
            trace_note = trace_dir
            log(f"[bench] profiler trace captured to {trace_dir}")
        except Exception as e:
            trace_note = f"failed: {type(e).__name__}: {e}"
            log(f"[bench] profiler trace failed: {e}")

    t0 = time.perf_counter()
    outs = [step(staged[i % ngen]) for i in range(n_blocks)]
    # one device-side reduction + two host fetches
    total_events = int(np.asarray(
        jnp.stack([n for _, n, _ in outs]).sum()))
    _ = np.asarray(jnp.stack([d for d, _, _ in outs]).sum(axis=0))
    dt = time.perf_counter() - t0
    max_raw = int(np.asarray(jnp.stack([m for _, _, m in outs]).max()))
    assert max_raw <= K, (
        f"K={K} overflowed: a cell had {max_raw} raw events — digest "
        "would silently truncate")

    # stats pipeline at global scale (device-resident end to end)
    ds0, _ = step_stats(staged[-1])
    assert np.isfinite(float(np.asarray(ds0)))
    _ = float(np.asarray(step_stats(staged[0])[0]))
    t1 = time.perf_counter()
    souts = [step_stats(staged[i % ngen]) for i in range(n_blocks)]
    _ = np.asarray(jnp.stack([d for d, _ in souts]).sum())
    dstats = time.perf_counter() - t1

    cells = n_blocks * C
    rate = cells / dt
    return {
        "name": "global_fused",
        "cells_per_sec_per_card": round(rate, 1),
        "wall_s": round(dt, 3),
        "cells": cells,
        "T_days": T,
        "events": total_events,
        "max_raw_events_per_cell": max_raw,
        "K": K,
        "warmup_events": warm_events,
        "global_oisst_1card_s": round(GLOBAL_CELLS / rate, 1),
        "with_stats_rank_wall_s": round(dstats, 3),
        "with_stats_rank_cells_per_sec": round(cells / dstats, 1),
        **({"profiler_trace": trace_note} if trace_note else {}),
    }, rate


def _gen_global_file(path, ny, nx, years, land_frac=0.33, seed=7):
    """Synthetic global SST NetCDF4 at `path`: (time, lat, lon) f32.

    Rank-B basis matmul per lat-stripe (seasonal cycle + multi-period
    oscillations with random per-cell coefficients — produces realistic
    multi-day exceedance runs) + a deterministic land mask. Generation is
    test harness, not framework; it runs once and is cached on disk.
    """
    import h5py

    from xmhw_tpu.xrlite.alloc import tune_malloc

    # ~6 GB of numpy temporaries per lat block; warm-arena reuse makes
    # generation disk-bound instead of page-fault-bound on this host
    tune_malloc()

    T = int(round(years * 365.25))
    t_raw = np.arange(T, dtype=np.float64)
    rng = np.random.default_rng(seed)
    # v2 periods: >= 2 weeks — the v1 mix (6-9 day oscillations) made
    # cells average ~45 events/40y with >128-event outliers (K=256),
    # far denser than real SST; realistic persistence keeps K ~ 64-128
    periods = [365.25, 182.6, 60.0, 37.0, 24.0, 15.5]
    B = 2 * len(periods)
    basis = np.empty((T, B), np.float32)
    for i, p in enumerate(periods):
        w = 2 * np.pi * t_raw / p
        basis[:, 2 * i] = np.sin(w)
        basis[:, 2 * i + 1] = np.cos(w)
    lat = np.linspace(-89.875, 89.875, ny).astype(np.float64)
    lon = np.linspace(0.125, 359.875, nx).astype(np.float64)
    # write to a temp name and rename at the end: an interrupted
    # generation must not leave a partial file that the exists-check
    # of a later run mistakes for the cached dataset
    final_path, path = path, path + ".tmp"
    # land: a smooth deterministic pattern covering ~land_frac
    li, lj = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    landfield = (np.sin(li * 0.11) * np.cos(lj * 0.07)
                 + 0.5 * np.sin(li * 0.031 + lj * 0.023))
    land = landfield > np.quantile(landfield, 1 - land_frac)

    with h5py.File(path, "w") as f:
        tnode = f.create_dataset("time", data=t_raw)
        tnode.attrs["units"] = "days since 1982-01-01 00:00:00"
        tnode.attrs["calendar"] = "standard"
        tnode.make_scale("time")
        ynode = f.create_dataset("lat", data=lat)
        ynode.attrs["units"] = "degrees_north"
        ynode.make_scale("lat")
        xnode = f.create_dataset("lon", data=lon)
        xnode.attrs["units"] = "degrees_east"
        xnode.make_scale("lon")
        v = f.create_dataset("sst", shape=(T, ny, nx), dtype="f4",
                             chunks=(min(T, 4096), 4, nx))
        v.attrs["units"] = "degree_C"
        for d, s in zip(v.dims, (tnode, ynode, xnode)):
            d.attach_scale(s)
        rows = max(1, int(2e9 / (T * nx * 4)))
        seas_amp = (3.0 + 5.0 * np.abs(lat) / 90.0).astype(np.float32)
        base_sst = (28.0 - 26.0 * (np.abs(lat) / 90.0) ** 1.5).astype(
            np.float32)
        for lo in range(0, ny, rows):
            hi = min(lo + rows, ny)
            cells = (hi - lo) * nx
            coef = rng.normal(0, 0.55, (B, cells)).astype(np.float32)
            coef[0] *= 0.2  # seasonal handled separately
            block = basis @ coef  # (T, cells)
            block = block.reshape(T, hi - lo, nx)
            block += base_sst[lo:hi, None]
            block += (seas_amp[lo:hi, None]
                      * np.sin(2 * np.pi * t_raw / 365.25)[:, None, None]
                      * np.sign(lat[lo:hi])[None, :, None]).astype(
                          np.float32)
            block[:, land[lo:hi]] = np.nan
            v[:, lo:hi] = block
    os.replace(path, final_path)
    return int((~land).sum())


def bench_global_streamed():
    """MEASURED file-to-file planet-scale run: stream_threshold +
    stream_detect + stream_block_average + stream_rank on a synthetic
    global NetCDF on disk, through the card. Reports wall time per
    stage, peak host RSS, and the device-step share. Scale via
    XMHW_BENCH_GLOBAL="NYxNXxYEARS" (default 180x240x40 ~ 2.5 GB input,
    ~29k ocean cells; the 0.25-degree original is 720x1440x40 ~ 60 GB,
    tools/fullscale_fused.py). When the remaining XMHW_BENCH_BUDGET_S
    cannot fit the requested scale, the config degrades to a smaller
    cached grid instead of being killed mid-run."""
    import xmhw_tpu as xm
    from xmhw_tpu.xrlite.alloc import maybe_trim_arena

    # release pages RETAINED (freed but resident) by earlier configs /
    # in-process file generation before resetting the watermark —
    # otherwise the "peak" of this config starts at the inflated
    # current RSS and reports their leftovers as ours (measured: the
    # fused pass alone peaks at 5.3 GB on the 2.8 GB input, while the
    # un-trimmed bench attributed 18.9 GB to it)
    maybe_trim_arena(min_free=0)
    rss_own = _reset_peak_rss()  # runs last; measure its own peak

    spec = os.environ.get("XMHW_BENCH_GLOBAL",
                          "24x48x3" if FAST else "180x240x40")
    # measured round 4: the default 2.5 GB spec runs ~6-7 min end to
    # end (staged 4-stage + fused single pass). Degrade by remaining
    # budget so the suite always emits a COMPLETE config set.
    degraded = None
    rem = _remaining()
    if not FAST and rem < 600:
        spec, degraded = "90x120x10", f"remaining budget {rem:.0f}s"
    if not FAST and rem < 180:
        spec, degraded = "24x48x3", f"remaining budget {rem:.0f}s"
    ny, nx, years = (int(x) for x in spec.split("x"))
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    src = os.path.join(cache, f"global_sst_v2_{ny}x{nx}x{years}.nc")
    tgen0 = time.perf_counter()
    if not os.path.exists(src):
        ocean = _gen_global_file(src, ny, nx, years)
        log(f"[bench] generated {src} ({os.path.getsize(src) / 1e9:.1f} "
            f"GB, {ocean} ocean cells) in "
            f"{time.perf_counter() - tgen0:.1f}s")
        # generation churns ~6 GB of arena temporaries; drop them so
        # the streamed run's RSS numbers are its own
        maybe_trim_arena(min_free=0)
        _reset_peak_rss()
    clim_out = os.path.join(cache, "global_clim.nc")
    mhw_out = os.path.join(cache, "global_mhw.nc")
    blk_out = os.path.join(cache, "global_block.nc")
    rank_out = os.path.join(cache, "global_rank.nc")

    from xmhw_tpu.core import pipeline as _pl

    # attribute device-step time: wrap the kernel-loop entry points
    def _timed(fn, acc):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            acc["s"] += time.perf_counter() - t0
            return out
        return wrap

    dev_t = {"s": 0.0}
    orig_clim, orig_det = _pl.run_clim, _pl.run_detect
    _pl.run_clim = _timed(orig_clim, dev_t)
    _pl.run_detect = _timed(orig_det, dev_t)
    import xmhw_tpu.stream as _st
    _st.run_clim, _st.run_detect = _pl.run_clim, _pl.run_detect
    try:
        t0 = time.perf_counter()
        xm.stream_threshold(src, "sst", clim_out)
        t1 = time.perf_counter()
        xm.stream_detect(src, "sst", clim_out, mhw_out,
                         events_layout="compact")
        t2 = time.perf_counter()
        xm.stream_block_average(mhw_out, blk_out, dstime_path=src,
                                dstime_var="sst", clim_path=clim_out)
        t3 = time.perf_counter()
        xm.stream_rank(mhw_out, rank_out)
        t4 = time.perf_counter()
    finally:
        _pl.run_clim, _pl.run_detect = orig_clim, orig_det
        _st.run_clim, _st.run_detect = orig_clim, orig_det

    import h5py

    with h5py.File(mhw_out, "r") as f:
        n_events = int(np.isfinite(f["event"][()]).sum())
    with h5py.File(src, "r") as f:
        # synthetic land is all-NaN along time: one slice identifies it
        ocean = int(np.isfinite(f["sst"][0]).sum())
    rss_gb = _peak_rss_gb()
    wall = t4 - t0
    td_wall = t2 - t0
    for p in (clim_out, mhw_out, blk_out, rank_out,
              rank_out[:-3] + "_return.nc"):
        if os.path.exists(p):
            os.remove(p)

    # ---- fused single-pass pipeline (stream_run): same four outputs,
    # ONE read + ONE upload of the data, all stages device-resident ----
    fus_t = {"s": 0.0}
    orig_fused = _pl.run_fused
    _pl.run_fused = _timed(orig_fused, fus_t)
    maybe_trim_arena(min_free=0)  # drop the staged run's retained churn
    rss_own &= _reset_peak_rss()  # the fused pass's own host peak
    f_clim = os.path.join(cache, "f_clim.nc")
    f_mhw = os.path.join(cache, "f_mhw.nc")
    f_blk = os.path.join(cache, "f_block.nc")
    f_rank = os.path.join(cache, "f_rank.nc")
    try:
        t5 = time.perf_counter()
        xm.stream_run(src, "sst", f_clim, f_mhw, block_path=f_blk,
                      rank_path=f_rank, events_layout="compact")
        t6 = time.perf_counter()
    finally:
        _pl.run_fused = orig_fused
    with h5py.File(f_mhw, "r") as f:
        n_events_f = int(np.isfinite(f["event"][()]).sum())
    fus_rss_gb = _peak_rss_gb()
    for p in (f_clim, f_mhw, f_blk, f_rank, f_rank[:-3] + "_return.nc"):
        if os.path.exists(p):
            os.remove(p)
    fwall = t6 - t5
    assert n_events_f == n_events, (n_events_f, n_events)

    return {
        "name": "global_streamed",
        **({"degraded_scale": degraded} if degraded else {}),
        "grid": f"{ny}x{nx}x{years}y",
        "input_gb": round(os.path.getsize(src) / 1e9, 2),
        "ocean_cells": ocean,
        "events": n_events,
        "threshold_s": round(t1 - t0, 1),
        "detect_s": round(t2 - t1, 1),
        "block_average_s": round(t3 - t2, 1),
        "rank_s": round(t4 - t3, 1),
        "wall_s": round(wall, 1),
        "threshold_detect_cells_per_sec": round(ocean / td_wall, 1),
        "device_step_s": round(dev_t["s"], 1),
        "device_step_share": round(dev_t["s"] / wall, 3),
        "peak_host_rss_gb": round(rss_gb, 2),
        # VmHWM reset failed (masked /proc): values are process-max,
        # inflated by the five configs that ran before this one
        **({} if rss_own else
           {"peak_host_rss_note": "process-max (VmHWM reset "
                                  "unavailable)"}),
        "fused_single_pass": {
            "wall_s": round(fwall, 1),
            "cells_per_sec_full_pipeline": round(ocean / fwall, 1),
            "device_step_s": round(fus_t["s"], 1),
            "device_step_share": round(fus_t["s"] / fwall, 3),
            "speedup_vs_staged": round(wall / fwall, 2),
            "peak_host_rss_gb": round(fus_rss_gb, 2),
        },
    }


def bench_point():
    """Config 1: single point, ~30-yr daily series, public API.

    Since round 5 points run on the host numpy engine (core/point.py) —
    no device, no compilation: cold ~50 ms vs 23.3 s in round 4 (and vs
    the reference's multi-second pandas point mode). XMHW_POINT_HOST=0
    restores the device path."""
    import xmhw_tpu as xm

    t = np.arange("1992-01-01", "2022-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ts = _host_series(T, 1, 1, land_frac=0.0)[:, 0, 0]
    da = _dataarray(ts[:, None, None], t).isel(lat=0, lon=0)

    t0 = time.perf_counter()
    clim = xm.threshold(da)
    mhw = xm.detect(da, clim["thresh"], clim["seas"])
    t1 = time.perf_counter()
    clim = xm.threshold(da)
    mhw = xm.detect(da, clim["thresh"], clim["seas"])
    t2 = time.perf_counter()
    return {
        "name": "single_point",
        "cold_s": round(t1 - t0, 3),  # incl. device acquisition + compile
        "warm_s": round(t2 - t1, 3),
        "T_days": T,
        "events": int(np.isfinite(mhw["event"].data).sum()),
    }


def bench_regional(years=None):
    """Config 2: Tasman-Sea-style 50x50 grid with land NaNs through the
    full public API (threshold + detect, union layout, host assembly
    included), skipna on and off."""
    import xmhw_tpu as xm

    years = years or (3 if FAST else 40)
    t = np.arange(f"{2022 - years}-01-01", "2022-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ny = nx = 16 if FAST else 50
    ts = _host_series(T, ny, nx)
    da = _dataarray(ts, t)
    ocean = int((~np.isnan(ts).all(axis=0)).sum())

    out = {"name": "tasman_regional", "T_days": T, "grid": f"{ny}x{nx}",
           "ocean_cells": ocean}
    # upload share, reported separately (docstring promise): time ONE
    # H2D ship of the ocean-compacted (T, C) block — the same transfer
    # threshold/detect perform per block; first and second transfer
    import jax.numpy as jnp

    comp = np.ascontiguousarray(ts[:, ~np.isnan(ts).all(axis=0)])
    tu0 = time.perf_counter()
    xdev = jnp.asarray(comp)
    float(xdev.ravel()[0])
    out["upload_cold_s"] = round(time.perf_counter() - tu0, 3)
    del xdev
    tu1 = time.perf_counter()
    xdev = jnp.asarray(comp)
    float(xdev.ravel()[0])
    out["upload_s_per_block"] = round(time.perf_counter() - tu1, 3)
    out["upload_mb"] = round(comp.nbytes / 1e6, 1)
    del xdev
    # NOTE: no skipna=True variant — threshold(skipna=...) is vacuous
    # here (NaNs never enter the percentile pool either way, matching
    # the reference's effective window_roll-dropna semantics,
    # api.py threshold docstring), so a separate skipna run would
    # measure nothing new
    rec = {}
    clim = mhw = None
    for phase in ("cold", "warm"):  # cold = compiles included
        del clim, mhw  # return the grids to the allocation pool
        t0 = time.perf_counter()
        clim = xm.threshold(da)
        t1 = time.perf_counter()
        mhw = xm.detect(da, clim["thresh"], clim["seas"])
        t2 = time.perf_counter()
        rec[f"threshold_{phase}_s"] = round(t1 - t0, 3)
        rec[f"detect_{phase}_s"] = round(t2 - t1, 3)
        rec[f"end_to_end_{phase}_s"] = round(t2 - t0, 3)
    rec["cells_per_sec"] = round(ocean / rec["end_to_end_warm_s"], 1)
    rec["events"] = int(np.isfinite(mhw["event"].data).sum())
    rec["skipna_note"] = ("skipna=True is accepted-but-vacuous "
                          "(see threshold docstring); not benched")
    out["skipna_false"] = rec
    return out


def bench_monthly():
    """Config 4: non-daily (monthly) tstep path through the public API."""
    import xmhw_tpu as xm
    from xmhw_tpu.xrlite import Coord, DataArray

    years = 3 if FAST else 40
    months = years * 12
    t = np.array([np.datetime64(f"{1982 + m // 12:04d}-"
                                f"{m % 12 + 1:02d}-15", "ns")
                  for m in range(months)])
    ny = nx = 16 if FAST else 50
    rng = np.random.default_rng(2)
    mon = np.arange(months, dtype=np.float32)[:, None, None]
    ts = (15 + 3 * np.sin(2 * np.pi * mon / 12)
          + rng.normal(0, 1.0, (months, ny, nx))).astype(np.float32)
    ts[:, rng.random((ny, nx)) < 0.3] = np.nan
    da = DataArray(
        ts, ("time", "lat", "lon"),
        {"time": Coord(("time",), t),
         "lat": Coord(("lat",), np.arange(ny, dtype=float)),
         "lon": Coord(("lon",), np.arange(nx, dtype=float))})
    ocean = int((~np.isnan(ts).all(axis=0)).sum())

    t0 = time.perf_counter()
    clim = xm.threshold(da, tstep=True)
    mhw = xm.detect(da, clim["thresh"], clim["seas"], tstep=True,
                    minDuration=3, maxGap=1)
    t1 = time.perf_counter()
    clim = xm.threshold(da, tstep=True)
    mhw = xm.detect(da, clim["thresh"], clim["seas"], tstep=True,
                    minDuration=3, maxGap=1)
    t2 = time.perf_counter()
    dt = t2 - t1
    return {
        "name": "monthly_tstep",
        "cold_s": round(t1 - t0, 3),
        "wall_s": round(dt, 3),
        "steps": months,
        "ocean_cells": ocean,
        "events": int(np.isfinite(mhw["event"].data).sum()),
    }


def bench_stats():
    """Config 5: full stats pipeline — threshold + detect (compact
    layout) + block_average(device) + mhw_rank."""
    import xmhw_tpu as xm

    years = 3 if FAST else 40
    t = np.arange(f"{2022 - years}-01-01", "2022-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    ny = nx = 16 if FAST else 50
    ts = _host_series(T, ny, nx, seed=5)
    da = _dataarray(ts, t)
    ocean = int((~np.isnan(ts).all(axis=0)).sum())

    t0 = time.perf_counter()
    clim = xm.threshold(da)
    mhw = xm.detect(da, clim["thresh"], clim["seas"],
                    events_layout="compact")
    t1 = time.perf_counter()
    block = xm.block_average(mhw, period=[2022 - years, 2021],
                             device=True)
    rank, ret = xm.mhw_rank(mhw)
    t2 = time.perf_counter()
    block = xm.block_average(mhw, period=[2022 - years, 2021],
                             device=True)
    rank, ret = xm.mhw_rank(mhw)
    t3 = time.perf_counter()
    warm_total = (t1 - t0) + (t3 - t2)
    return {
        "name": "stats_pipeline",
        "threshold_detect_s": round(t1 - t0, 3),
        "stats_cold_s": round(t2 - t1, 3),
        "stats_warm_s": round(t3 - t2, 3),
        "end_to_end_s": round(warm_total, 3),
        "cells_per_sec": round(ocean / warm_total, 1),
        "ocean_cells": ocean,
        "block_vars": len(list(block.keys())),
        "ranked_vars": len(list(rank.keys())),
    }


def _card():
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"unknown (nvidia-smi rc={out.returncode})"


def main():
    import jax

    d = jax.devices()
    if d[0].platform != "gpu":
        log(f"[bench] needs an NVIDIA GPU; JAX's platform is "
            f"{d[0].platform!r}")
        sys.exit(2)
    device = {"platform": d[0].platform, "kind": d[0].device_kind,
              "count": len(d)}
    card = _card()
    log(f"[bench] device {device}; card {card}")

    configs = {}
    state = {"rate": None, "done": False}

    def _emit():
        rate = state["rate"] or 0.0
        # the full config detail goes to its own file + a stderr line;
        # the final stdout line stays short
        detail = {"device": device, "card": card, "configs": configs}
        try:
            path = os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "bench_detail.json")
            with open(path, "w") as f:
                json.dump(detail, f, indent=1)
        except OSError as e:
            log(f"[bench] bench_detail.json write failed: {e}")
        log("[bench] detail: " + json.dumps(detail))
        print(json.dumps({
            "metric": "threshold_detect_cells_per_sec_per_card",
            "value": round(rate, 1),
            "unit": "cells/s",
            "device": device,
            "card": card,
        }), flush=True)

    # If the suite is stopped mid-run, still write the detail with every
    # config measured so far, and exit non-zero. global_fused runs FIRST
    # so the headline rate is secured early. XMHW_BENCH_BUDGET_S is a
    # self-imposed deadline for the same purpose.
    import signal

    def _dump_and_exit(signum, frame):
        if not state["done"]:
            configs["_truncated"] = {"signal": signal.Signals(signum).name}
            _emit()
        os._exit(1)

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM,
                signal.SIGHUP):
        try:
            signal.signal(sig, _dump_and_exit)
        except (OSError, ValueError):
            pass
    budget = int(os.environ.get("XMHW_BENCH_BUDGET_S", "2400"))
    if budget:
        signal.alarm(budget)
        global _DEADLINE
        # leave headroom for the final fetch/emit before the alarm
        _DEADLINE = time.monotonic() + budget - 60

    # global_streamed runs LAST: it is the longest config, and it
    # resets the kernel peak-RSS watermark (VmHWM) on entry so its RSS
    # numbers are still its own despite running late
    for fn in (bench_global_fused, bench_point, bench_regional,
               bench_monthly, bench_stats, bench_global_streamed):
        name = fn.__name__
        log(f"[bench] running {name} ...")
        t0 = time.perf_counter()
        try:
            res = fn()
            if isinstance(res, tuple):
                res, state["rate"] = res
            configs[res.pop("name")] = res
            log(f"[bench] {name} done in "
                f"{time.perf_counter() - t0:.1f}s: {res}")
        except Exception as e:  # record, keep the suite going
            configs[name] = {"error": f"{type(e).__name__}: {e}"}
            log(f"[bench] {name} FAILED: {e}")

    state["done"] = True
    signal.alarm(0)
    _emit()
    failed = [k for k, v in configs.items() if "error" in v]
    if failed:
        log(f"[bench] failed configs: {failed}")
        sys.exit(1)


if __name__ == "__main__":
    main()
