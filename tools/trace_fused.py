"""Per-op attribution of the fused threshold+detect step on the GPU.

Replicates bench.py's global_fused step (one 4096-cell block, 40-year
daily series), captures a jax.profiler trace of ONE warm step, then
parses the perfetto trace.json.gz for per-op device durations on the
GPU device planes.

Usage:
    python tools/trace_fused.py [trace_dir]

The reference has no profiling story (SURVEY.md §5); this is the
equivalent named there (jax.profiler traces + timing harness).
"""
import glob
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from xmhw_tpu.core.calendar import build_window_ranges, compute_doy
    from xmhw_tpu.core.features_scan import detect_kernel
    from xmhw_tpu.core.pipeline import _kernel_clim_block
    from xmhw_tpu.xrlite import TimeIndex

    t = np.arange("1982-01-01", "2022-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    doy, ndoy = compute_doy(TimeIndex(t))
    starts_np, lens_np, ny, rmax = build_window_ranges(doy, 5, ndoy)
    C, K = 4096, 128
    starts = jnp.asarray(starts_np.reshape(-1))
    lens = jnp.asarray(lens_np.reshape(-1))
    doy_pos = jnp.asarray((doy - 1).astype(np.int32))

    @jax.jit
    def gen(key):
        day = jnp.arange(T, dtype=jnp.float32)[:, None]
        base = 15 + 3 * jnp.sin(2 * jnp.pi * day / 365.25)
        noise = jax.random.normal(key, (T, C), jnp.float32)
        sm = sum(jnp.roll(noise, k, 0) for k in range(-7, 8)) / 15.0
        return base + 2.5 * sm

    @jax.jit
    def step(ts):
        th, se = _kernel_clim_block(
            ts, starts, lens, ndoy=ndoy, ny=ny, rmax=rmax,
            pctile=90, smooth=True, smooth_w=31, patch_feb29=True)
        table, nev, _ = detect_kernel(ts, th, se, doy_pos, K=K)
        digest = jnp.stack(
            [jnp.nansum(v.astype(jnp.float32)) for v in table.values()])
        return digest, jnp.sum(nev), jnp.max(nev)

    ts_p = gen(jax.random.PRNGKey(0))
    d, nev, _ = step(ts_p)  # compile + warm
    _ = float(jnp.sum(d))
    for _i in range(3):  # clock ramp
        d, _, _ = step(ts_p)
    _ = float(jnp.sum(d))

    out_dir = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="xmhw_trace_")
    import time
    t0 = time.perf_counter()
    with jax.profiler.trace(out_dir):
        d, _, _ = step(ts_p)
        _ = float(jnp.sum(d))
    wall = time.perf_counter() - t0
    print(f"traced one warm step: wall {wall*1e3:.1f} ms (incl. the "
          f"digest fetch); trace dir {out_dir}")

    files = glob.glob(os.path.join(
        out_dir, "**", "*.trace.json.gz"), recursive=True)
    if not files:
        print("no trace.json.gz produced"); return
    with gzip.open(max(files, key=os.path.getmtime), "rt") as f:
        tr = json.load(f)
    events = tr.get("traceEvents", [])
    # GPU device planes are the processes named "/device:GPU:<n>"
    gpu_pids = {ev.get("pid") for ev in events
                if ev.get("ph") == "M" and ev.get("name") == "process_name"
                and "/device:GPU" in str((ev.get("args") or {})
                                         .get("name", ""))}
    by_op = defaultdict(float)
    total = 0.0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("pid") not in gpu_pids:
            continue
        dur = ev.get("dur", 0) / 1e3  # us -> ms
        by_op[ev.get("name", "")] += dur
        total += dur
    if not by_op:
        # fallback: take the longest-duration thread's events
        for ev in events:
            if ev.get("ph") == "X" and ev.get("dur", 0) > 50:
                by_op[ev.get("name", "?")] += ev["dur"] / 1e3
                total += ev["dur"] / 1e3
    print(f"\ndevice op total: {total:.1f} ms")
    for name, dur in sorted(by_op.items(), key=lambda kv: -kv[1])[:40]:
        print(f"{dur:9.2f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
