"""2-process ``jax.distributed`` dryrun of the sharded pipeline.

The single-process driver dryrun (__graft_entry__.dryrun_multichip)
validates the 8-device mesh inside one process; THIS tool validates the
multi-HOST claim (parallel/mesh.py:12-14): two OS processes join a
global mesh via ``jax.distributed`` (gloo collectives on CPU), each
feeds only its ADDRESSABLE shards (parallel.mesh.make_cell_array — the
path a multi-host stream.py deployment uses to read only its own cell
stripes), the fused threshold+detect step jit-compiles over the global
mesh, and every process asserts its local output shards bit-match a
locally computed unsharded reference.

Run: python tools/multihost_dryrun.py           # launches both ranks
     python tools/multihost_dryrun.py RANK PORT # one rank (internal)

Exercised by tests/test_multihost.py.
"""

from __future__ import annotations

import os
import subprocess
import sys

N_PROC = 2
DEV_PER_PROC = 4
T_YEARS = 2
C_GLOBAL = 32  # multiple of the 8 global devices
K = 8


def _child(rank: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=N_PROC, process_id=rank)
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from xmhw_tpu.core.calendar import build_window_index, compute_doy
    from xmhw_tpu.core.pipeline import fused_threshold_detect
    from xmhw_tpu.parallel.mesh import (cell_mesh, make_cell_array,
                                        replicated)
    from xmhw_tpu.xrlite import TimeIndex

    devs = jax.devices()
    assert len(devs) == N_PROC * DEV_PER_PROC, len(devs)
    mesh = cell_mesh(devs)

    t = np.arange("2000-01-01", f"{2000 + T_YEARS}-01-01",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    T = len(t)
    doy, ndoy = compute_doy(TimeIndex(t))
    gidx_np, _ = build_window_index(doy, 5, ndoy)
    doy_pos_np = (doy - 1).astype(np.int32)

    # deterministic global field: every process can produce any shard
    # (in production this is a GridReader hyperslab read of the cells
    # this host owns) AND the full local reference
    tt = np.arange(T, dtype=np.float32)[:, None]
    cc = np.arange(C_GLOBAL, dtype=np.float32)[None, :]
    full = (15 + 3 * np.sin(2 * np.pi * tt / 365.25)
            + 1.5 * np.sin(0.37 * tt + 2.1 * cc)
            + 1.0 * np.sin(0.11 * tt * (1 + 0.05 * cc))).astype(
                np.float32)

    ts = make_cell_array(mesh, (T, C_GLOBAL),
                         lambda idx: full[idx])  # addressable-shard feed
    gidx = jax.device_put(jnp.asarray(gidx_np), replicated(mesh))
    doy_pos = jax.device_put(jnp.asarray(doy_pos_np), replicated(mesh))

    th, se, table, n_events = fused_threshold_detect(
        ts, gidx, doy_pos, K=K, min_duration=3, max_gap=1)

    # local unsharded reference on the full grid (tiny)
    th_r, se_r, table_r, n_r = fused_threshold_detect(
        jnp.asarray(full), jnp.asarray(gidx_np),
        jnp.asarray(doy_pos_np), K=K, min_duration=3, max_gap=1)
    th_r, se_r, n_r = (np.asarray(x) for x in (th_r, se_r, n_r))
    table_r = {k: np.asarray(v) for k, v in table_r.items()}

    checked = 0
    for shard in th.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      th_r[shard.index])
        checked += 1
    for shard in n_events.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      n_r[shard.index])
    for name in ("event", "duration", "intensity_max", "rate_onset"):
        for shard in table[name].addressable_shards:
            np.testing.assert_array_equal(
                np.nan_to_num(np.asarray(shard.data), nan=-9e9),
                np.nan_to_num(table_r[name][shard.index], nan=-9e9))
    total = int(np.asarray(
        jax.jit(lambda n: n.sum(),
                out_shardings=replicated(mesh))(n_events)))
    print(f"rank {rank}: OK — {checked} local th shards checked, "
          f"{total} events across the global mesh", flush=True)


def main() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        # children stay on the CPU: they never open a card
        subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          str(r), str(port)],
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
        for r in range(N_PROC)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=600)
    print("multihost dryrun:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    if len(sys.argv) >= 3:
        _child(int(sys.argv[1]), int(sys.argv[2]))
    else:
        sys.exit(main())
