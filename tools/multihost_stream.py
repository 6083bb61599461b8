"""2-process ``jax.distributed`` dryrun of the STREAMED file-to-file
pipeline: each process runs ``stream_run`` on its own latitude band
(``grid_rows``), a barrier synchronizes them, and rank 0 merges the
band files (:func:`xmhw_tpu.merge_grid_band_files`) and derives ranks /
return periods from the merged event tables with ``stream_rank``
(nYears is a record-span GLOBAL, so per-band rank files would
disagree; the staged rank pass on the merged file is the multi-host
assembly the reference's manual split/recombine workflow implies —
reference: docs/dask.rst:44-86). Every output is asserted BYTE-equal
to a single-process run of the same pipeline.

Band edges ALIGN with the stripe edges (split at row 5 = the stripe
width): each stripe then contains the identical ocean-cell set in the
banded and single-process runs, so the compiled block shapes match and
float32 results are bit-reproducible. (A misaligned band was tried
first: one severity_var element differed by 1 ulp — XLA re-associates
f32 reductions differently per block shape. Alignment is also the
natural deployment: bands tile the stripe grid.)

Run: python tools/multihost_stream.py           # launches both ranks
     python tools/multihost_stream.py RANK PORT DIR  # one rank
Exercised by tests/test_multihost.py.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

N_PROC = 2
NY, NX, YEARS = 12, 8, 3
STRIPE = 5
SPLIT = 5  # band edge — aligned to STRIPE (see module docstring)


def _write_input(path):
    import h5py

    T = int(round(YEARS * 365.25))
    t = np.arange(T, dtype=np.float64)
    rng = np.random.default_rng(11)
    ts = (15 + 3 * np.sin(2 * np.pi * t / 365.25)[:, None, None]
          + rng.normal(0, 1.5, (T, NY, NX))).astype(np.float32)
    land = rng.random((NY, NX)) < 0.2
    ts[:, land] = np.nan
    with h5py.File(path, "w") as f:
        tn = f.create_dataset("time", data=t)
        tn.attrs["units"] = "days since 2000-01-01 00:00:00"
        tn.attrs["calendar"] = "standard"
        tn.make_scale("time")
        yn = f.create_dataset("lat", data=np.linspace(-40, -30, NY))
        yn.make_scale("lat")
        xn = f.create_dataset("lon", data=np.linspace(150, 157, NX))
        xn.make_scale("lon")
        v = f.create_dataset("sst", data=ts)
        v.attrs["units"] = "degree_C"
        for d, s in zip(v.dims, (tn, yn, xn)):
            d.attach_scale(s)


def _assert_h5_equal(a_path, b_path, skip_attrs=("history",)):
    import h5py

    with h5py.File(a_path, "r") as a, h5py.File(b_path, "r") as b:
        ka, kb = set(a.keys()), set(b.keys())
        assert ka == kb, (a_path, ka ^ kb)
        for name in ka:
            va, vb = a[name][()], b[name][()]
            assert va.shape == vb.shape, (name, va.shape, vb.shape)
            if np.issubdtype(va.dtype, np.floating):
                np.testing.assert_array_equal(
                    np.nan_to_num(va, nan=-9e9),
                    np.nan_to_num(vb, nan=-9e9), err_msg=name)
            else:
                np.testing.assert_array_equal(va, vb, err_msg=name)
        for k, v in a.attrs.items():
            if k in skip_attrs:
                continue
            assert str(b.attrs.get(k)) == str(v), (k, v, b.attrs.get(k))


def _child(rank: int, port: int, d: str) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=N_PROC, process_id=rank)
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import xmhw_tpu as xm

    src = os.path.join(d, "sst.nc")
    band = (0, SPLIT) if rank == 0 else (SPLIT, NY)
    paths = {k: os.path.join(d, f"{k}_r{rank}.nc")
             for k in ("clim", "mhw", "block")}
    xm.stream_run(src, "sst", paths["clim"], paths["mhw"],
                  block_path=paths["block"], stripe=STRIPE,
                  grid_rows=band)

    # barrier: every process must finish writing before rank 0 merges
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax.make_mesh((len(jax.devices()),), ("d",))
    tot = jax.jit(
        lambda x: x.sum(),
        out_shardings=NamedSharding(mesh, P()))(
        jax.device_put(jnp.ones(len(jax.devices())),
                       NamedSharding(mesh, P("d"))))
    assert float(tot) == len(jax.devices())

    if rank == 0:
        bands = [(0, SPLIT), (SPLIT, NY)]
        for k in ("clim", "mhw", "block"):
            xm.merge_grid_band_files(
                [(os.path.join(d, f"{k}_r{r}.nc"), lo, hi)
                 for r, (lo, hi) in enumerate(bands)],
                os.path.join(d, f"{k}_merged.nc"), band_dim="lat")
        xm.stream_rank(os.path.join(d, "mhw_merged.nc"),
                       os.path.join(d, "rank_merged.nc"))

        # single-process reference: same pipeline, full grid
        ref = {k: os.path.join(d, f"{k}_ref.nc")
               for k in ("clim", "mhw", "block")}
        xm.stream_run(src, "sst", ref["clim"], ref["mhw"],
                      block_path=ref["block"], stripe=STRIPE)
        xm.stream_rank(ref["mhw"], os.path.join(d, "rank_ref.nc"))

        for k in ("clim", "mhw", "block"):
            _assert_h5_equal(os.path.join(d, f"{k}_merged.nc"), ref[k])
        _assert_h5_equal(os.path.join(d, "rank_merged.nc"),
                         os.path.join(d, "rank_ref.nc"))
        _assert_h5_equal(os.path.join(d, "rank_merged_return.nc"),
                         os.path.join(d, "rank_ref_return.nc"))
        print("rank 0: OK — merged band outputs byte-equal to the "
              "single-process run", flush=True)
    else:
        print(f"rank {rank}: band {band} written", flush=True)


def main() -> int:
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        _write_input(os.path.join(d, "sst.nc"))
        procs = [
            # children stay on the CPU: they never open a card
            subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              str(r), str(port), d],
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
            for r in range(N_PROC)
        ]
        rc = 0
        for p in procs:
            rc |= p.wait(timeout=900)
    print("multihost stream dryrun:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    if len(sys.argv) >= 4:
        _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
