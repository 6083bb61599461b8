#!/usr/bin/env python
"""Full-scale fused planet run: stream_run on a ~60 GB global NetCDF.

Measures the SINGLE-PASS pipeline (climatology + detect + block stats +
ranks, one read + one upload per stripe) file-to-file on the GPU at
the reference's documented global scale — 0.25-degree OISST, 720x1440
grid x 40 years (reference workflow: docs/dask.rst:44-86). The staged
pipeline at this scale re-uploads the same data at every stage; the
fused path is the one worth measuring.

Usage:
    python tools/fullscale_fused.py [NYxNXxYEARS] [--stripe ROWS] \
        [--out PATH]

Writes a JSON record (default fullscale.json at the repo root) with wall
time, per-stage device share, peak host RSS, event counts and rates.
"""

import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    spec = "720x1440x40"
    stripe = None
    rank = False
    out_json = os.path.join(ROOT, "fullscale.json")
    args = sys.argv[1:]
    while args:
        a = args.pop(0)
        if a == "--stripe":
            stripe = int(args.pop(0))
        elif a == "--out":
            out_json = args.pop(0)
        elif a == "--rank":
            # rank + return-period files are each (24 vars x K x grid)
            # f4 — ~25 GB apiece at 720x1440/K=256, which together with
            # the ~61 GB input and ~46 GB of clim/mhw/block outputs
            # overflows this host's 120 GB free disk. Off by default at
            # full scale; the rank stage itself is measured at the
            # 360x480 bench scale (BENCH global_streamed) and is
            # byte-parity tested against the staged stream_rank.
            rank = True
        else:
            spec = a
    ny, nx, years = (int(x) for x in spec.split("x"))

    from xmhw_tpu.xrlite.alloc import tune_malloc

    # generation allocates ~6 GB of numpy temporaries per lat block;
    # keep them in the warm arena
    tune_malloc()

    from bench import _gen_global_file, log

    cache = os.path.join(ROOT, ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    src = os.path.join(cache, f"global_sst_v2_{ny}x{nx}x{years}.nc")
    t0 = time.perf_counter()
    if not os.path.exists(src):
        ocean = _gen_global_file(src, ny, nx, years)
        log(f"[fullscale] generated {src} "
            f"({os.path.getsize(src) / 1e9:.1f} GB, {ocean} ocean cells) "
            f"in {time.perf_counter() - t0:.1f}s")

    import h5py
    import numpy as np

    with h5py.File(src, "r") as f:
        ocean = int(np.isfinite(f["sst"][0]).sum())
        T = f["sst"].shape[0]
    log(f"[fullscale] {spec}: {ocean} ocean cells, T={T}, "
        f"{os.path.getsize(src) / 1e9:.1f} GB on disk")

    import xmhw_tpu as xm
    from xmhw_tpu.core import pipeline as _pl
    from bench import _peak_rss_gb, _reset_peak_rss
    from xmhw_tpu.xrlite.alloc import maybe_trim_arena

    # measure the RUN's own peak: drop pages retained by in-process
    # file generation (freed but resident under the no-trim arena
    # policy) and restart the kernel watermark; fall back to process
    # ru_maxrss only where VmHWM reset is unsupported
    maybe_trim_arena(min_free=0)
    hwm_own = _reset_peak_rss()

    dev_t = {"s": 0.0}
    orig = _pl.run_fused

    def timed(*a, **k):
        t = time.perf_counter()
        r = orig(*a, **k)
        dev_t["s"] += time.perf_counter() - t
        return r

    _pl.run_fused = timed
    keys = ("clim", "mhw", "block") + (("rank",) if rank else ())
    paths = {k: os.path.join(cache, f"fullscale_{k}.nc") for k in keys}
    try:
        t1 = time.perf_counter()
        # resume=True: a fresh run when no watermark exists; an
        # interrupted full-scale run (the hour-long case resume exists
        # for) picks up its clean prefix instead of starting over
        xm.stream_run(src, "sst", paths["clim"], paths["mhw"],
                      block_path=paths["block"],
                      rank_path=paths.get("rank"),
                      events_layout="compact", stripe=stripe,
                      resume=True)
        t2 = time.perf_counter()
    finally:
        _pl.run_fused = orig

    with h5py.File(paths["mhw"], "r") as f:
        n_events = int(np.isfinite(f["event"][()]).sum())
        K = f["event"].shape[0]
    out_gb = sum(os.path.getsize(p) for p in paths.values()
                 if os.path.exists(p)) / 1e9
    rss_gb = (_peak_rss_gb() if hwm_own else
              resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)
    wall = t2 - t1
    rec = {
        "config": "fullscale_fused_single_pass",
        "grid": f"{ny}x{nx}x{years}y",
        "input_gb": round(os.path.getsize(src) / 1e9, 2),
        "output_gb": round(out_gb, 2),
        "ocean_cells": ocean,
        "T_days": T,
        "events": n_events,
        "K": K,
        "wall_s": round(wall, 1),
        "cells_per_sec_full_pipeline": round(ocean / wall, 1),
        "device_step_s": round(dev_t["s"], 1),
        "device_step_share": round(dev_t["s"] / wall, 3),
        "peak_host_rss_gb": round(rss_gb, 2),
        "stripe_rows": stripe,
        "stages": ("clim+detect+block_average"
                   + ("+rank" if rank else "")
                   + " (one upload per stripe)"),
    }
    for p in paths.values():
        if os.path.exists(p):
            os.remove(p)
    if rank:
        rp = paths["rank"][:-3] + "_return.nc"
        if os.path.exists(rp):
            os.remove(rp)
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(rec, f, indent=1)
    log(f"[fullscale] {json.dumps(rec)}")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
