"""Host <-> device orchestration: cell blocking, sharding, K selection.

Replaces the reference's dask.delayed graph build + ``dask.compute``
scheduler boundary (reference: xmhw/xmhw.py:182-197, 440-454) with a simple
deterministic loop: cells are processed in fixed-size blocks (static shapes
-> one XLA compilation), each block optionally sharded over a device mesh.
Blocking bounds HBM use for planet-scale grids — the analogue of the
reference's documented manual grid splitting (reference: docs/dask.rst:44-86)
but automatic and without task-graph overhead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.mesh import cell_mesh, cell_sharding, pad_cells, replicated
from . import engine
from .clim import clim_kernel, feb29_patch, runavg_circular
from .events import mhw_filter
from .features_scan import detect_kernel


def _auto_block(T: int, Z: int, ndoy: int, n_dev: int,
                budget_bytes: float = 6e9) -> int:
    """Pick a power-of-two cell-block size so peak device memory fits
    the budget: the climatology gather holds ~2 (ndoy, Z, B) buffers and
    the detect kernel ~25 live (T, B) arrays.
    """
    per_cell = max(2 * ndoy * Z * 4, 25 * T * 4)
    b = int(budget_bytes / max(per_cell, 1))
    b = max(128, min(b, 1 << 16))
    # round down to a power of two for stable compilation shapes
    b = 1 << (b.bit_length() - 1)
    return max(b, n_dev) if n_dev > 1 else b


class CellRunner:
    """Runs a jitted kernel over (time, cell) data in padded cell blocks."""

    def __init__(self, n_cells: int, T: int, Z: int = 1, ndoy: int = 366,
                 block: int | None = None, mesh=None, use_mesh: bool = True):
        self.mesh = mesh
        if mesh is None and use_mesh and len(jax.devices()) > 1:
            self.mesh = cell_mesh()
        n_dev = len(self.mesh.devices.flat) if self.mesh else 1
        self.block = block or _auto_block(T, Z, ndoy, n_dev)
        if self.mesh and self.block % n_dev:
            self.block = -(-self.block // n_dev) * n_dev
        # when the grid is smaller than the block, shrink — but only to
        # a COARSE quantum (1024 cells): streamed pipelines feed stripes
        # whose ocean-cell counts all differ, and a per-stripe block
        # shape would compile a fresh program per stripe (seconds each).
        # NaN padding is dropped on output, so over-padding costs only
        # bandwidth.
        q = 1024 * max(n_dev, 1) if n_cells > 1024 else max(n_dev, 1)
        self.block = min(self.block, max(n_dev, -(-n_cells // q) * q))
        self.n_cells = n_cells

    def device_block(self, arr_np: np.ndarray, lo: int) -> jax.Array:
        """Slice cells [lo, lo+block), pad with NaN, ship to device(s)."""
        blk = arr_np[..., lo:lo + self.block]
        blk, _ = pad_cells(blk, self.block)
        x = jnp.asarray(blk)
        if self.mesh:
            x = jax.device_put(x, cell_sharding(self.mesh, x.ndim))
        return x

    def device_replicated(self, arr_np: np.ndarray) -> jax.Array:
        x = jnp.asarray(arr_np)
        if self.mesh:
            x = jax.device_put(x, replicated(self.mesh))
        return x

    def blocks(self):
        return range(0, self.n_cells, self.block)


@jax.jit
def _concat_rows(xs):
    return jnp.concatenate(xs, axis=0)


def fetch_rows(d):
    """Download a dict of 2-D (rows_i, C) device arrays with ONE
    transfer per dtype group, concatenating along rows on device first.

    Event tables, climatologies, block stats and counters all share the
    cell axis, so any mix of them concatenates: the ~65 per-variable
    fetches of a fused block collapse to ~2 transfers."""
    groups = {}
    for k, v in d.items():
        groups.setdefault(np.dtype(v.dtype), []).append(k)
    out = {}
    for dt, ks in groups.items():
        if len(ks) == 1:
            out[ks[0]] = np.asarray(d[ks[0]])
            continue
        stacked = np.asarray(_concat_rows([d[k] for k in ks]))
        lo = 0
        for k in ks:
            r = d[k].shape[0]
            out[k] = stacked[lo:lo + r]
            lo += r
    return out


@functools.partial(jax.jit, static_argnames=("size",))
def _slice_cols(a, lo, size):
    return jax.lax.dynamic_slice_in_dim(a, lo, size, axis=a.ndim - 1)


class _BlockSource:
    """Per-block device input: either one stripe-wide upload sliced on
    device (single-device path — one transfer instead of one per
    block), or per-block uploads (mesh path, or stripes too large to
    keep resident)."""

    def __init__(self, runner: CellRunner, arr_np, budget=2e9):
        from ..xrlite.alloc import alloc_empty

        self.runner = runner
        self.arr = arr_np
        self.whole = None
        if runner.mesh is None and arr_np is not None:
            n_blocks = -(-runner.n_cells // runner.block)
            cp = n_blocks * runner.block
            c = arr_np.shape[-1]
            if arr_np.nbytes / max(c, 1) * cp <= budget:
                if cp == c:
                    padded = arr_np
                else:
                    padded = alloc_empty(arr_np.shape[:-1] + (cp,),
                                         arr_np.dtype)
                    padded[..., :c] = arr_np
                    padded[..., c:] = (np.nan if np.issubdtype(
                        arr_np.dtype, np.floating) else 0)
                self.whole = jnp.asarray(padded)

    def block(self, lo):
        if self.whole is None:
            return self.runner.device_block(self.arr, lo)
        return _slice_cols(self.whole, lo, self.runner.block)


def _kernel_clim_tables(dtype, doy_np, w, ndoy):
    """Range tables (starts, lens, ny, rmax) when the percentile kernel
    serves this climatology, else None: the engine must be the GPU's,
    the data float32, and each doy may occur at most once per year
    (duplicate sub-daily centers pool through the gather table)."""
    from .calendar import build_window_ranges

    if engine.device_engine() != "gpu" or dtype != np.float32:
        return None
    try:
        return build_window_ranges(doy_np, w, ndoy)
    except ValueError:
        return None


@functools.partial(
    jax.jit,
    static_argnames=("ndoy", "ny", "rmax", "pctile", "smooth", "smooth_w",
                     "patch_feb29", "interpret"),
)
def _kernel_clim_block(ts, starts, lens, ndoy, ny, rmax, pctile, smooth,
                       smooth_w, patch_feb29, interpret=False):
    """clim_kernel's contract with the pooled percentile + mean from the
    Pallas kernel (ops/pallas/doy_quantile.py)."""
    from ..ops.pallas.doy_quantile import pallas_doy_clim

    th, se = pallas_doy_clim(ts, starts, lens, ndoy=ndoy, ny=ny,
                             rmax=rmax, pctile=pctile, interpret=interpret)
    if patch_feb29:
        th = feb29_patch(th)
        se = feb29_patch(se)
    if smooth:
        th = runavg_circular(th, smooth_w)
        se = runavg_circular(se, smooth_w)
    return th, se


def _clim_block_fn(runner, doy_np, w, ndoy, pctile, smooth, smooth_w,
                   patch_feb29, dtype):
    """The per-block climatology program for ``runner``'s blocks:
    returns fn(ts_block) -> (thresh, seas), each (ndoy, block)."""
    tables = _kernel_clim_tables(dtype, doy_np, w, ndoy)
    if tables is None:
        from .calendar import build_window_index

        gidx_np, _ = build_window_index(doy_np, w, ndoy)
        gidx = runner.device_replicated(gidx_np)
        return lambda ts: clim_kernel(ts, gidx, pctile=pctile,
                                      smooth=smooth, smooth_w=smooth_w,
                                      patch_feb29=patch_feb29)

    from ..ops.pallas import doy_quantile

    starts_np, lens_np, ny, rmax = tables
    starts = runner.device_replicated(starts_np.reshape(-1))
    lens = runner.device_replicated(lens_np.reshape(-1))
    statics = dict(ndoy=ndoy, ny=ny, rmax=rmax, pctile=pctile,
                   smooth=smooth, smooth_w=smooth_w,
                   patch_feb29=patch_feb29,
                   interpret=doy_quantile.INTERPRET)
    if runner.mesh is not None:
        fn = _sharded_kernel_clim(runner.mesh, **statics)
    else:
        fn = functools.partial(_kernel_clim_block, **statics)
    return lambda ts: fn(ts, starts, lens)


def run_clim(ts_np: np.ndarray, doy_np: np.ndarray, w: int, ndoy: int,
             pctile: int, smooth: bool, smooth_w: int, patch_feb29: bool,
             block: int | None = None, mesh=None, use_mesh=True):
    """Climatology for all cells: (T, C) -> (thresh, seas) as (ndoy, C).

    Device calc_clim (reference: xmhw/xmhw.py:250-307) over cell blocks,
    on the engine :func:`engine.device_engine` picks.
    """
    T, C = ts_np.shape
    out_t = np.empty((ndoy, C), ts_np.dtype)
    out_s = np.empty((ndoy, C), ts_np.dtype)
    # pooled-set size bound: every occurrence of a doy pools 2w+1 days
    Z = (2 * w + 1) * int(np.bincount(np.asarray(doy_np)).max())
    runner = CellRunner(C, T, Z, ndoy, block=block, mesh=mesh,
                        use_mesh=use_mesh)
    clim_block = _clim_block_fn(runner, doy_np, w, ndoy, pctile, smooth,
                                smooth_w, patch_feb29, ts_np.dtype)
    src = _BlockSource(runner, ts_np)
    for lo in runner.blocks():
        th, se = clim_block(src.block(lo))
        hi = min(lo + runner.block, C)
        got = fetch_rows({"th": th, "se": se})
        out_t[:, lo:hi] = got["th"][:, : hi - lo]
        out_s[:, lo:hi] = got["se"][:, : hi - lo]
    return out_t, out_s


@functools.partial(
    jax.jit,
    static_argnames=("pctile", "smooth", "smooth_w", "patch_feb29", "K",
                     "min_duration", "join_gaps", "max_gap"),
)
def fused_threshold_detect(ts, gidx, doy_pos, pctile=90, smooth=True,
                           smooth_w=31, patch_feb29=True, K=64,
                           min_duration=5, join_gaps=True, max_gap=2):
    """threshold() + detect() as ONE fused XLA program for a cell block.

    The climatology never leaves the device: the percentile/mean feed the
    detection gather directly. This is the flagship compute step used by
    the benchmark and the multi-chip dry run; sharding the trailing cell
    axis over a mesh parallelizes it with zero collectives.
    """
    th, se = clim_kernel(ts, gidx, pctile=pctile, smooth=smooth,
                         smooth_w=smooth_w, patch_feb29=patch_feb29)
    table, n_events, _ = detect_kernel(
        ts, th, se, doy_pos, K=K, min_duration=min_duration,
        join_gaps=join_gaps, max_gap=max_gap, intermediate=False)
    return th, se, table, n_events


@functools.partial(
    jax.jit, static_argnames=("min_duration", "join_gaps", "max_gap",
                              "day0_fillna_quirk"))
def _count_kernel(ts, th, pos, min_duration, join_gaps, max_gap,
                  day0_fillna_quirk=False):
    """Cheap counting pass: events per cell (fixes K before the feature
    pass). Module-level jit so repeated detect() calls reuse the
    compilation."""
    return mhw_filter(ts > th[pos], min_duration=min_duration,
                      join_gaps=join_gaps, max_gap=max_gap,
                      day0_fillna_quirk=day0_fillna_quirk)["n_events"]


def _round_k(k: int) -> int:
    """Round event capacity up to limit recompilation (32, then pow2)."""
    k = max(k, 1)
    if k <= 32:
        return 32
    return 1 << (k - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _sharded_kernel_clim(mesh, **static_kw):
    """_kernel_clim_block wrapped in shard_map, cached per
    (mesh, statics): each device runs the kernel on its cell shard."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import CELL_AXIS

    fn = functools.partial(_kernel_clim_block, **static_kw)
    return jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, CELL_AXIS), P(), P()),
        out_specs=(P(None, CELL_AXIS), P(None, CELL_AXIS)),
        check_vma=False))


@functools.partial(
    jax.jit,
    static_argnames=("K", "min_duration", "join_gaps", "max_gap",
                     "day0_fillna_quirk", "cold"))
def _detect_cold(ts, th, se, doy_pos, K, min_duration, join_gaps, max_gap,
                 day0_fillna_quirk, cold):
    """detect_kernel on the device-resident block; ``cold`` negates the
    series on device (the staged path negates on host, reference:
    xmhw/xmhw.py:412-413)."""
    if cold:
        ts = -ts
    return detect_kernel(ts, th, se, doy_pos, K=K,
                         min_duration=min_duration, join_gaps=join_gaps,
                         max_gap=max_gap, intermediate=False,
                         day0_fillna_quirk=day0_fillna_quirk)


@functools.partial(
    jax.jit,
    static_argnames=("T", "nbins", "day_edges", "count_nans",
                     "rank_names", "cold"))
def fused_stats_kernel(table, ts_pad, th, se, doy_pos, ybod, T, nbins,
                       day_edges, count_nans, rank_names, cold):
    """The full stats layer on a device-resident detect output: one jit
    computing the year-block event aggregations (reference:
    xmhw/stats.py:322-363), the per-day ts/category block stats
    (stats.py:366-428) and the per-cell ordinal ranks (stats.py:446-510)
    without the event tables or the day series ever leaving the device.

    ``table``: detect_kernel output dict (device). ``ts_pad``: the
    ORIGINAL (un-negated) series block — day stats always run on the
    input values even for coldSpells, matching the staged pipeline
    where block_average reads the raw SST file. ``ybod``: (T,) int32
    year-bin per timestep, -1 = outside the requested period.
    ``rank_names``: static tuple of table variables to rank (empty
    tuple skips ranking). ``cold``: flip intensity values (but not
    variances) before aggregating/ranking, matching flip_cold applied
    to the staged detect file (reference: xmhw/features.py:298-315).
    Returns {"block": {...}, "day": {...}, "rank": {...}}.
    """
    from .stats import (EVENT_VARS, binned_day_stats, binned_event_stats,
                        rank_events_desc)

    ts = jax.lax.slice_in_dim(ts_pad, 0, T, axis=0)
    dt = ts.dtype

    def flip(name, v):
        if cold and "intensity" in name and "_var" not in name:
            return -v
        return v

    out = {}
    if nbins:
        tstart = table["time_start"]
        bin_idx = ybod[jnp.clip(tstart, 0, T - 1)]
        valid = (tstart >= 0) & (bin_idx >= 0)
        vals = jnp.stack([flip(k, table[k]).astype(dt)
                          for k in EVENT_VARS])
        out["block"] = binned_event_stats(
            vals, jnp.clip(bin_idx, 0, nbins - 1), valid, nbins)
        from .stats import category_index

        cats = category_index(ts, th[doy_pos], se[doy_pos])
        out["day"] = binned_day_stats(ts, cats, day_edges,
                                      with_cats=True,
                                      count_nans=count_nans)
    if rank_names:
        ones = jnp.ones(table["time_start"].shape, bool)
        out["rank"] = {
            k: rank_events_desc(flip(k, table[k]).astype(dt), ones)
            for k in rank_names}
    return out


def run_fused(ts_np, doy_np, doy_pos_np, *, w=5, ndoy=366, pctile=90,
              smooth=True, smooth_w=31, patch_feb29=True, min_duration=5,
              join_gaps=True, max_gap=2, day0_fillna_quirk=False,
              cold_spells=False, ts_clim_np=None, doy_clim_np=None,
              ts_day_np=None, ybod_np=None, nbins=0, day_edges=None,
              count_nans=False, rank_names=(), det_mask_np=None,
              block=None, mesh=None, k_min=None, k_cap=None):
    """Single-upload fused pipeline for all cells: climatology + detect
    + year-block stats + ranks, each cell block shipped to the device
    ONCE and every stage consuming the previous stage's device-resident
    output. This replaces the reference's
    staged workflow (threshold -> detect -> block_average -> mhw_rank,
    docs/gettingstarted.rst:158-188) which re-reads and re-uploads the
    same series at every stage.

    ``ts_np``: (T, C) ORIGINAL series (not negated, not interpolated —
    pass ``maxPadLength``-interpolated data here and the raw series as
    ``ts_day_np`` to reproduce the staged stats semantics).
    ``ts_clim_np``/``doy_clim_np``: optional climatologyPeriod subset
    for the climatology stage (defaults: the full series).
    ``ybod_np``: (T,) int32 year-bin of each timestep (-1 outside the
    period); with ``nbins``/``day_edges`` enables the stats stage.
    ``rank_names``: table variables to rank on device.
    ``det_mask_np``: (C,) bool — cells excluded from detection (e.g.
    any-NaN cells under ``anynans``) get NaN thresholds, so they yield
    no events and NaN categories while their day stats still compute,
    matching the staged pipeline where the clim file is NaN there.

    Returns (th, se, tables, n_events, extras) where extras holds
    numpy "block"/"day"/"rank" dicts for the enabled stages.
    """
    from ..xrlite.alloc import alloc_filled

    T, C = ts_np.shape
    if ts_clim_np is None:
        ts_clim_np, doy_clim_np = ts_np, doy_np
    same_clim = ts_clim_np is ts_np
    runner = CellRunner(C, T, 2 * w + 1, ndoy, block=block, mesh=mesh,
                        use_mesh=False)
    clim_block = _clim_block_fn(runner, doy_clim_np, w, ndoy, pctile,
                                smooth, smooth_w, patch_feb29, ts_np.dtype)
    doy_pos = runner.device_replicated(doy_pos_np)
    with_stats = bool(nbins)
    ybod = (runner.device_replicated(ybod_np.astype(np.int32))
            if with_stats else None)

    kcap_eff = int(k_cap) if k_cap is not None else None

    def _cap(k):
        return min(k, kcap_eff) if kcap_eff is not None else k

    def _fill_of(v):
        return -1 if np.issubdtype(v.dtype, np.integer) else np.nan

    out_t = np.empty((ndoy, C), ts_np.dtype)
    out_s = np.empty((ndoy, C), ts_np.dtype)
    n_events = np.zeros(C, np.int32)
    tables = None
    extras = {}
    dropped = 0
    K = _cap(_round_k(int(k_min))) if k_min else None
    main_src = _BlockSource(runner, ts_np)
    clim_src = main_src if same_clim else _BlockSource(runner, ts_clim_np)
    day_src = (_BlockSource(runner, ts_day_np)
               if ts_day_np is not None else None)
    mask_src = (_BlockSource(runner, det_mask_np.astype(ts_np.dtype))
                if det_mask_np is not None else None)
    for lo in runner.blocks():
        x = main_src.block(lo)
        xc = x if same_clim else clim_src.block(lo)
        xneg = _neg_jit(x) if cold_spells else x
        xcneg = ((xneg if same_clim else _neg_jit(xc))
                 if cold_spells else xc)
        th, se = clim_block(xcneg)
        if mask_src is not None:
            m = mask_src.block(lo)
            th = _mask_cols(th, m)
            se = _mask_cols(se, m)
        if K is None:
            n = _count_kernel(xneg, th, doy_pos,
                              min_duration=min_duration,
                              join_gaps=join_gaps, max_gap=max_gap,
                              day0_fillna_quirk=day0_fillna_quirk)
            K = _cap(_round_k(int(jnp.max(n))))
        while True:
            tbl, nev, _ = _detect_cold(
                x, th, se, doy_pos, K=K, min_duration=min_duration,
                join_gaps=join_gaps, max_gap=max_gap,
                day0_fillna_quirk=day0_fillna_quirk, cold=cold_spells)
            raw_max = int(jnp.max(nev))
            if raw_max <= K or _cap(_round_k(raw_max)) == K:
                break
            K = _cap(_round_k(raw_max))
        if with_stats or rank_names:
            xd = day_src.block(lo) if day_src is not None else x
            st = fused_stats_kernel(
                tbl, xd, th, se, doy_pos, ybod, T=T, nbins=nbins,
                day_edges=day_edges, count_nans=count_nans,
                rank_names=tuple(rank_names), cold=cold_spells)
        else:
            st = {}
        # ---- downloads: EVERYTHING in ~2 transfers (one per dtype) -----
        parts = {("clim", "th"): th, ("clim", "se"): se,
                 ("nev", "nev"): nev[None, :]}
        for k, v in tbl.items():
            parts[("tbl", k)] = v
        for part, d in st.items():
            for k, v in d.items():
                parts[(part, k)] = v
        fetched = fetch_rows(parts)
        nev = fetched[("nev", "nev")][0]
        tbl_h = {k: fetched[("tbl", k)] for k in tbl}
        st_h = {part: {k: fetched[(part, k)] for k in d}
                for part, d in st.items()}
        dropped += int(np.maximum(nev - K, 0).sum())
        hi = min(lo + runner.block, C)
        wd = hi - lo
        n_events[lo:hi] = np.minimum(nev, K)[:wd]
        out_t[:, lo:hi] = fetched[("clim", "th")][:, :wd]
        out_s[:, lo:hi] = fetched[("clim", "se")][:, :wd]
        if tables is None:
            tables = {k: alloc_filled((K, C), _fill_of(v), v.dtype)
                      for k, v in tbl_h.items()}
            for part, d in st_h.items():
                rows = {k: alloc_filled(
                    (v.shape[0], C), 0.0 if str(k).endswith("_days")
                    else np.nan, v.dtype)
                    for k, v in d.items()}
                extras[part] = rows
        elif next(iter(tables.values())).shape[0] < K:
            for k, old in tables.items():
                grown = alloc_filled((K, C), _fill_of(old), old.dtype)
                grown[:old.shape[0]] = old
                tables[k] = grown
            if "rank" in extras:
                for k, old in extras["rank"].items():
                    grown = alloc_filled((K, C), np.nan, old.dtype)
                    grown[:old.shape[0]] = old
                    extras["rank"][k] = grown
        for k, v in tbl_h.items():
            tables[k][:v.shape[0], lo:hi] = v[:, :wd]
        for part, d in st_h.items():
            for k, v in d.items():
                extras[part][k][:v.shape[0], lo:hi] = v[:, :wd]

    if dropped:
        from ..utils import logger

        logger.warning(
            "k_cap=%d truncated the event table: %d event(s) dropped "
            "across the grid", k_cap, dropped)
    return out_t, out_s, tables, n_events, extras


_neg_jit = jax.jit(jnp.negative)


@jax.jit
def _mask_cols(a, m):
    """NaN out columns where the 0/1 mask (NaN-padded) is not 1."""
    return jnp.where(m[None, :] == 1, a, jnp.asarray(jnp.nan, a.dtype))


def run_detect(ts_np, th_np, se_np, doy_pos_np, min_duration, join_gaps,
               max_gap, intermediate=False, block=None, mesh=None,
               k_cap=None, day0_fillna_quirk=False, k_min=None,
               first_k=None, use_mesh=True):
    """Detection for all cells: returns (tables dict of (K, C) numpy,
    n_events (C,), inter dict of (T, C) numpy).

    ``th_np``/``se_np`` are (D, C) doy climatologies; ``doy_pos_np`` (T,)
    maps timesteps to climatology rows (broadcast happens on device).

    Each cell block is uploaded ONCE and stays device-resident; H2D
    traffic is one ts/th/se transfer per block. The event-table capacity
    K is fixed by a cheap counting pass on the FIRST block only; later
    blocks run the feature pass optimistically and retry with a larger K
    when the raw per-cell counts (returned by detect_kernel even beyond
    K) overflow the table — in the common case that saves one full
    mhw_filter pass per block. K values are rounded (32, then powers of
    two) so at most a handful of kernel variants compile; the host output
    is padded to the global maximum. Replaces the per-cell define_events
    fan-out (reference: xmhw/xmhw.py:440-454, identify.py:328-412).
    """
    T, C = ts_np.shape
    runner = CellRunner(C, T, block=block, mesh=mesh, use_mesh=use_mesh)

    # the cap is the user's EXACT memory contract — never round it up
    kcap_eff = int(k_cap) if k_cap is not None else None

    def _cap(k):
        return min(k, kcap_eff) if kcap_eff is not None else k

    def _fill_of(v):
        return -1 if np.issubdtype(v.dtype, np.integer) else np.nan

    from ..xrlite.alloc import alloc_empty, alloc_filled

    n_events = np.zeros(C, np.int32)
    dropped = 0
    # first_k: start optimistically at this capacity WITHOUT the counting
    # pass — the feature kernel's raw counts catch overflow and retry.
    # Saves compiling + dispatching the whole counting program; used by
    # the single-point path where one extra retry would be cheap anyway.
    K = _cap(_round_k(int(first_k))) if first_k else None
    tables = None  # host outputs, written block-by-block (no buffering)
    inter_out = {}
    doy_pos = runner.device_replicated(doy_pos_np)
    ts_src = _BlockSource(runner, ts_np)
    th_src = _BlockSource(runner, th_np)
    se_src = _BlockSource(runner, se_np)
    for lo in runner.blocks():
        ts = ts_src.block(lo)
        th = th_src.block(lo)
        se = se_src.block(lo)
        if K is None:
            n = _count_kernel(ts, th, doy_pos, min_duration=min_duration,
                              join_gaps=join_gaps, max_gap=max_gap,
                              day0_fillna_quirk=day0_fillna_quirk)
            # k_min: callers processing many chunks (stream_detect) pass
            # the K discovered so far, so later chunks start at the
            # stable capacity instead of regrowing (and recompiling the
            # kernel per K variant) chunk after chunk
            K = _cap(_round_k(max(int(jnp.max(n)), int(k_min or 1))))
        while True:
            tbl, nev, inter = detect_kernel(
                ts, th, se, doy_pos, K=K, min_duration=min_duration,
                join_gaps=join_gaps, max_gap=max_gap,
                intermediate=intermediate,
                day0_fillna_quirk=day0_fillna_quirk)
            raw_max = int(jnp.max(nev))
            if raw_max <= K or _cap(_round_k(raw_max)) == K:
                break
            K = _cap(_round_k(raw_max))  # overflow: retry larger
        # ONE stacked transfer per dtype group for tables + counters
        # (+ the per-day intermediate when requested)
        parts = {("nev", "nev"): nev[None, :]}
        for k, v in tbl.items():
            parts[("tbl", k)] = v
        for k, v in inter.items():
            parts[("inter", k)] = v
        fetched = fetch_rows(parts)
        nev = fetched[("nev", "nev")][0]
        dropped += int(np.maximum(nev - K, 0).sum())  # only under k_cap
        hi = min(lo + runner.block, C)
        w = hi - lo
        n_events[lo:hi] = np.minimum(nev, K)[:w]
        if tables is None:
            tables = {k: alloc_filled((K, C), _fill_of(v), v.dtype)
                      for k, v in tbl.items()}
            if intermediate:
                inter_out = {k: alloc_empty((T, C), v.dtype)
                             for k, v in inter.items()}
        elif next(iter(tables.values())).shape[0] < K:
            # rare overflow growth: keep the written prefix rows
            for k, old in tables.items():
                grown = alloc_filled((K, C), _fill_of(old), old.dtype)
                grown[:old.shape[0]] = old
                tables[k] = grown
        for k in tbl:
            v = fetched[("tbl", k)]
            tables[k][:v.shape[0], lo:hi] = v[:, :w]
        for k in inter:
            inter_out[k][:, lo:hi] = fetched[("inter", k)][:, :w]

    if dropped:
        from ..utils import logger

        logger.warning(
            "k_cap=%d truncated the event table: %d event(s) dropped "
            "across the grid", k_cap, dropped)
    return tables, n_events, inter_out
