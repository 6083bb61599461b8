"""Pallas GPU kernel (Triton route): window-pool percentile + mean.

The XLA path (core/clim.doy_clim) materializes the pooled tensor
(ndoy, Z, C) in device memory (~2.7 GB at 4096 cells / 40 years) and makes
33 counting passes over it. Here one program owns one (doy, cell-tile)
pool: it gathers the pooled rows straight from the (T, C) series into
registers, runs the radix-select percentile and the masked mean on them,
and writes one output row segment. Each series row is read by the ~11
doys whose windows cover it; with doys varying fastest in the launch
order, those reads hit L2.

Semantics identical to doy_clim's float32 path (linear-interpolation
percentile on the NaN-dropped pooled multiset, reference:
xmhw/identify.py:184-270): the selected order statistics are exact, so
thresh is bit-equal; seas sums in another order (float32 rounding).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...core.clim import (_I32_MAX, _float_key, _key_to_float,
                          _quantile_rank_frac)

# Tests set this to run the kernel through the Pallas interpreter on the
# CPU; nothing else does.
INTERPRET = False

# cells per program: the pool of next_pow2(ny*rmax) x BLOCK_C float32
# values (512 x 16 at 40 years) lives in the registers of 4 warps
BLOCK_C = 16
NUM_WARPS = 4


def _next_pow2(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def _kernel(starts_ref, lens_ref, ts_ref, th_ref, se_ref, *, T, C, ny,
            rmax, zp, bc, pctile):
    d = pl.program_id(0)
    c0 = pl.program_id(1) * bc

    # pool row z <- window offset r of year y (z = y*rmax + r)
    z = lax.broadcasted_iota(jnp.int32, (zp,), 0)
    y = z // rmax
    r = z - y * rmax
    z_ok = z < ny * rmax
    tab = d * ny + jnp.minimum(y, ny - 1)
    start = plgpu.load(starts_ref.at[tab], mask=z_ok, other=0)
    ln = plgpu.load(lens_ref.at[tab], mask=z_ok, other=0)
    row_ok = z_ok & (r < ln)
    rows = jnp.clip(start + r, 0, T - 1)
    cols = c0 + lax.broadcasted_iota(jnp.int32, (bc,), 0)
    col_ok = cols < C
    vals = plgpu.load(ts_ref.at[rows[:, None],
                                jnp.minimum(cols, C - 1)[None, :]],
                      mask=row_ok[:, None] & col_ok[None, :],
                      other=jnp.nan)  # (zp, bc)

    mask = jnp.isfinite(vals)
    n = jnp.sum(mask, axis=0, dtype=jnp.int32)  # (bc,)
    k, frac = _quantile_rank_frac(n, pctile, jnp.float32)
    key = jnp.where(mask, _float_key(vals), _I32_MAX)

    # greedy MSB-first bisection on the signed key domain (see
    # core.clim._select_quantile): bit b of lo is still clear, except the
    # sign bit of the start value, so XOR sets the unsigned bit b
    def bit(i, lo):
        cand = lo ^ lax.shift_left(jnp.int32(1),
                                   (31 - i).astype(jnp.int32))
        cnt = jnp.sum(key < cand[None, :], axis=0, dtype=jnp.int32)
        return jnp.where(cnt <= k, cand, lo)

    lo = lax.fori_loop(0, 32, bit,
                       jnp.full((bc,), -0x80000000, jnp.int32))
    vk = _key_to_float(lo)
    cnt_le = jnp.sum(key <= lo[None, :], axis=0, dtype=jnp.int32)
    hik = jnp.min(jnp.where(key > lo[None, :], key, _I32_MAX),
                  axis=0)
    vk1 = jnp.where(cnt_le > k + 1, vk,
                    jnp.where(hik != _I32_MAX, _key_to_float(hik), vk))
    th = vk + frac * (vk1 - vk)
    ssum = jnp.sum(jnp.where(mask, vals, 0.0), axis=0)
    se = ssum / jnp.maximum(n, 1).astype(jnp.float32)

    nanv = jnp.float32(jnp.nan)
    plgpu.store(th_ref.at[d, cols], jnp.where(n > 0, th, nanv),
                mask=col_ok)
    plgpu.store(se_ref.at[d, cols], jnp.where(n > 0, se, nanv),
                mask=col_ok)


@functools.partial(
    jax.jit,
    static_argnames=("ndoy", "ny", "rmax", "pctile", "interpret"))
def pallas_doy_clim(ts, starts, lens, ndoy, ny, rmax, pctile=90,
                    interpret=False):
    """Pooled percentile + mean for all cells of a (T, C) float32 block.

    ``starts``/``lens``: flat (ndoy*ny,) int32 range tables from
    core.calendar.build_window_ranges. Returns (thresh, seas), each
    (ndoy, C) float32, NaN where a pool is empty.
    """
    T, C = ts.shape
    bc = min(BLOCK_C, _next_pow2(C))
    kernel = functools.partial(
        _kernel, T=T, C=C, ny=ny, rmax=rmax, zp=_next_pow2(ny * rmax),
        bc=bc, pctile=pctile)
    out = jax.ShapeDtypeStruct((ndoy, C), jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(ndoy, pl.cdiv(C, bc)),
        out_shape=(out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="doy_quantile",
    )(starts, lens, ts.astype(jnp.float32))
