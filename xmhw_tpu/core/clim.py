"""Device-side climatology: windowed doy quantile/mean, feb29, smoothing.

Accelerator redesign of the reference's per-cell dask pipeline
(window_roll -> groupby(doy).quantile/mean -> feb29 -> runavg;
reference: xmhw/identify.py:184-270, 137-181). Instead of materializing an
11x-length stacked series per cell and looping cells through a dask graph,
we compute ALL cells at once on dense ``(time, cell)`` arrays:

* a static int32 gather table (built once on host,
  :func:`xmhw_tpu.core.calendar.build_window_index`) maps each doy bucket to
  its pooled time indices;
* one gather produces a dense ``(ndoy, Z, cell)`` tensor; a masked sort
  yields the linear-interpolation percentile (matching numpy/xarray
  ``quantile``) with per-(doy, cell) valid counts — this reproduces
  window_roll's dropna semantics (NaN values never enter the pool,
  reference: identify.py:208) for BOTH skipna modes;
* the Feb-29 patch averages doys 59..61 (reference: identify.py:137-151);
* the circular running-mean smoother is a sum of rolls on the doy axis —
  exactly periodic, NaN-propagating like the reference's pad(wrap)+rolling
  (reference: identify.py:154-181).

Everything is jit-compiled and vectorized over the trailing cell axis, so
sharding the cell axis over a device mesh parallelizes it with zero
communication.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# numpy scalars trace as literals, so kernels may close over them
_I32_MAX = np.int32(0x7FFFFFFF)
_SIGN = np.int32(-0x80000000)


def _float_key(x):
    """Monotonic float32 -> SIGNED int32 key (total order).

    The classic unsigned key u (flip sign bit for positives, bitwise-not
    negatives) is carried in the order-preserving signed form
    r = bitcast_i32(u ^ 0x80000000), so every device path (XLA and the
    Pallas kernel) compares and reduces plain int32.
    """
    bits = lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    # u = neg ? ~bits : bits | 0x80000000 ; r = u ^ 0x80000000
    return jnp.where(bits < 0, ~bits ^ _SIGN, bits)


def _key_to_float(r):
    u_high = r >= 0  # u had its high bit set <=> r is non-negative
    bits = jnp.where(u_high, r, ~(r ^ _SIGN))
    return lax.bitcast_convert_type(bits, jnp.float32)


def _quantile_rank_frac(n, pctile, dt):
    """Order-statistic rank k and interpolation fraction for position
    q*(n-1), q = pctile/100.

    For integral ``pctile`` (the reference API's case) the position is
    computed EXACTLY in int32 — pctile*(n-1) = 100*k + rem — so
    near-integer positions (e.g. 90% of n=451 -> 405.0) can never floor
    to the adjacent rank the way float32 arithmetic can. Non-integral
    percentiles fall back to float arithmetic.
    """
    if float(pctile).is_integer():
        num = (n - 1) * jnp.int32(int(pctile))
        k = jnp.maximum(num // 100, 0)
        frac = (jnp.maximum(num - k * 100, 0).astype(dt)
                / jnp.asarray(100, dt))
    else:
        pos = jnp.asarray(pctile / 100.0, dt) * (n.astype(dt) - 1.0)
        k = jnp.maximum(jnp.floor(pos).astype(jnp.int32), 0)
        frac = pos - k.astype(dt)
    return k, frac


def _select_quantile(vals, mask, pctile):
    """Linear-interpolation quantile via radix-select (sort-free).

    A comparator sort is the costly way to the pooled percentile on an
    accelerator; a 32-step binary search on the monotone int32 key space needs
    only counting passes over the pooled axis — ~100x less memory traffic
    than a full sort. Exactly equivalent to numpy's 'linear' method on the
    masked multiset: finds order statistics k and k+1, interpolates
    (including tied values spanning the k/k+1 boundary).

    vals/mask: (D, Z, C); returns (D, C).
    """
    dt = vals.dtype
    key = jnp.where(mask, _float_key(vals), _I32_MAX)
    n = jnp.sum(mask, axis=1)  # (D, C)
    k, frac = _quantile_rank_frac(n, pctile, dt)

    # greedy MSB-first bisection on the signed key domain: start at
    # INT32_MIN (all-zero unsigned pattern) and try setting each unsigned
    # bit; bit 31 of u toggles the sign of r, handled by XOR with _SIGN.
    def body(i, lo):
        b = 31 - i
        cand = lo | lax.bitcast_convert_type(jnp.uint32(1) << b, jnp.int32)
        # setting unsigned bit 31 == flipping the signed sign bit
        cand = jnp.where(b == 31, lo ^ _SIGN, cand)
        cnt = jnp.sum((key < cand[:, None, :]).astype(jnp.int32), axis=1)
        return jnp.where(cnt <= k, cand, lo)

    lo = lax.fori_loop(0, 32, body,
                       jnp.full(n.shape, _SIGN, jnp.int32))
    vk = _key_to_float(lo).astype(dt)
    # (k+1)-th order statistic: with ties spanning position k+1 it EQUALS
    # vk; otherwise it is the smallest key strictly greater than lo
    cnt_le = jnp.sum((key <= lo[:, None, :]).astype(jnp.int32), axis=1)
    gt = jnp.where(key > lo[:, None, :], key, _I32_MAX)
    hik = jnp.min(gt, axis=1)
    has_next = hik != _I32_MAX
    vk1 = jnp.where(cnt_le > k + 1, vk,
                    jnp.where(has_next, _key_to_float(hik).astype(dt), vk))
    out = vk + frac * (vk1 - vk)
    return jnp.where(n > 0, out, jnp.nan)


def _masked_sort(vals, mask):
    """Sort ``vals`` ascending along axis 1 with invalid entries last.

    Returns (sorted_vals, n_valid) where n_valid counts valid entries per
    (doy, cell).
    """
    big = jnp.asarray(jnp.inf, vals.dtype)
    vals = jnp.where(mask, vals, big)
    svals = jnp.sort(vals, axis=1)
    n = jnp.sum(mask, axis=1)  # (ndoy, cell)
    return svals, n


def _interp_quantile(svals, n, pctile):
    """Linear-interpolation quantile of pre-sorted values.

    Matches numpy's default 'linear' method used by pandas/xarray groupby
    quantile (reference: identify.py:233-235): position = q*(n-1), with
    the rank/fraction computed exactly in int32 for integral pctile
    (numpy's own float64 position differs by <=1e-14 of one
    inter-order-statistic gap — below every parity tolerance).
    """
    dtype = svals.dtype
    lo, frac = _quantile_rank_frac(n, pctile, dtype)
    hi = lo + (frac > 0)
    lo = jnp.clip(lo, 0, svals.shape[1] - 1)
    hi = jnp.clip(hi, 0, svals.shape[1] - 1)
    vlo = jnp.take_along_axis(svals, lo[:, None, :], axis=1)[:, 0, :]
    vhi = jnp.take_along_axis(svals, hi[:, None, :], axis=1)[:, 0, :]
    out = vlo + frac * (vhi - vlo)
    return jnp.where(n > 0, out, jnp.nan)


@functools.partial(jax.jit, static_argnames=("pctile",))
def doy_clim(ts, gidx, pctile):
    """Windowed day-of-year percentile threshold and mean climatology.

    Parameters
    ----------
    ts: (T, C) float array — SST per (time, cell); NaN = missing
    gidx: (ndoy, Z) int32 — pooled time indices per doy bucket, -1 padded
    pctile: static int — threshold percentile (reference default 90)

    Returns
    -------
    thresh, seas: (ndoy, C) arrays (NaN where a bucket is empty)
    """
    pos_ok = gidx >= 0  # (ndoy, Z)
    safe_idx = jnp.where(pos_ok, gidx, 0)
    vals = ts[safe_idx]  # (ndoy, Z, C)
    mask = pos_ok[..., None] & jnp.isfinite(vals)
    if ts.dtype == jnp.float64:
        # exact-parity path (CPU): comparator sort on float64
        svals, n = _masked_sort(vals, mask)
        thresh = _interp_quantile(svals, n, pctile)
    else:
        # float32 path: sort-free radix-select on int32 keys
        n = jnp.sum(mask, axis=1)
        thresh = _select_quantile(vals, mask, pctile)
    ssum = jnp.sum(jnp.where(mask, vals, 0.0), axis=1)
    seas = jnp.where(n > 0, ssum / jnp.maximum(n, 1).astype(ts.dtype),
                     jnp.nan)
    return thresh, seas


def feb29_patch(clim):
    """Overwrite doy 60 (row 59) with nanmean of doys 59..61.

    The reference deliberately averages 28 Feb, 29 Feb and 1 Mar (skipna),
    diverging from Oliver's original two-day average
    (reference: identify.py:137-151, applied at identify.py:237-240).
    Only meaningful for ndoy == 366 (tstep=False path).
    """
    rows = clim[58:61]  # doys 59,60,61
    m = jnp.isfinite(rows)
    s = jnp.sum(jnp.where(m, rows, 0.0), axis=0)
    c = jnp.sum(m, axis=0)
    mean = jnp.where(c > 0, s / jnp.maximum(c, 1).astype(clim.dtype), jnp.nan)
    return clim.at[60 - 1].set(mean)  # row 59 == doy 60


def runavg_circular(clim, w):
    """Periodic centered running mean of width ``w`` on the doy axis.

    NaN-propagating, like the reference's pad(wrap) + rolling(center).mean
    (reference: identify.py:154-181). ``w`` must be odd (validated at the
    API layer, reference: xmhw.py:103-104 / identify.py:173-174).
    """
    half = (w - 1) // 2
    acc = jnp.zeros_like(clim)
    for k in range(-half, half + 1):
        acc = acc + jnp.roll(clim, -k, axis=0)
    return acc / jnp.asarray(w, clim.dtype)


@functools.partial(
    jax.jit,
    static_argnames=("pctile", "smooth", "smooth_w", "patch_feb29"),
)
def clim_kernel(ts, gidx, pctile=90, smooth=True, smooth_w=31,
                patch_feb29=True):
    """Fused climatology pipeline: pooling -> quantile/mean -> feb29 ->
    circular smoothing. One XLA program per cell block; replaces the
    reference's delayed graph calc_clim (reference: xmhw.py:250-307).
    """
    thresh, seas = doy_clim(ts, gidx, pctile)
    if patch_feb29:
        thresh = feb29_patch(thresh)
        seas = feb29_patch(seas)
    if smooth:
        thresh = runavg_circular(thresh, smooth_w)
        seas = runavg_circular(seas, smooth_w)
    return thresh, seas
