"""Lightweight labeled arrays: the I/O shell of the framework.

The reference is built on xarray Datasets (reference: xmhw/xmhw.py:19,
README.rst:16-21) — but xarray/dask are deliberately *not* dependencies
here. The compute core works on dense JAX arrays; this module provides just
enough labeled-array structure to round-trip dims/coords/attrs and NetCDF
files, so a user of the reference finds the same user-facing surface:

* ``DataArray``: numpy-backed data + named dims + coords + attrs
* ``Dataset``: mapping of variables sharing coords, plus global attrs
* ``.sel``/``.isel``/``.stack``/``.unstack``/``.dropna`` analogues used by
  the pipeline (reference land_check/unstack: identify.py:482-529,
  xmhw.py:210-214)
* NetCDF4(HDF5) I/O lives in :mod:`xmhw_tpu.xrlite.netcdf`.

Design note: this layer is intentionally host-side numpy only. Anything
performance-critical happens in :mod:`xmhw_tpu.core` on device; keeping the
shell dumb means the XLA program never sees ragged/labelled structure.
"""

from __future__ import annotations

import numpy as np

from .timeutils import TimeIndex


def _asarray(values):
    if isinstance(values, TimeIndex):
        return values
    return np.asarray(values)


class Coord:
    """A coordinate variable: values along one (or zero) dims + attrs."""

    __slots__ = ("dims", "values", "attrs")

    def __init__(self, dims, values, attrs=None):
        self.dims = tuple(dims)
        self.values = _asarray(values)
        self.attrs = dict(attrs or {})

    def copy(self):
        return Coord(self.dims, self.values, dict(self.attrs))

    def __len__(self):
        return len(self.values)

    def __repr__(self):
        return f"Coord(dims={self.dims}, shape={np.shape(self.values)})"


def _coord_values(c):
    v = c.values
    return v.values if isinstance(v, TimeIndex) else v


class DataArray:
    """N-dimensional labeled array (numpy-backed host shell)."""

    def __init__(self, data, dims, coords=None, attrs=None, name=None):
        self.data = _asarray(data)
        self.dims = tuple(dims)
        if np.ndim(self.data) != len(self.dims):
            raise ValueError(
                f"data ndim {np.ndim(self.data)} != len(dims) {self.dims}"
            )
        self.coords: dict[str, Coord] = {}
        for k, v in (coords or {}).items():
            if isinstance(v, Coord):
                self.coords[k] = v.copy()
            elif isinstance(v, tuple) and len(v) in (2, 3):
                # xarray convention: a bare string names ONE dim
                # (tuple('cell') would explode into characters)
                cdims = (v[0],) if isinstance(v[0], str) else tuple(v[0])
                self.coords[k] = Coord(cdims, *v[1:])
            else:
                # scalar or 1-D coord named after its dim
                arr = _asarray(v)
                # np.ndim would iterate a TimeIndex's __getitem__ into
                # infinitely nested singletons — it is always 1-D
                nd = 1 if isinstance(arr, TimeIndex) else np.ndim(arr)
                cdims = (k,) if (nd == 1 and k in self.dims) else ()
                if nd == 1 and k not in self.dims and len(arr) == 1:
                    arr = arr[0] if not isinstance(arr, TimeIndex) else arr
                if nd >= 1 and not cdims:
                    raise ValueError(
                        f"coordinate {k!r} has {np.ndim(arr)}-D values but "
                        f"no dimension: name it after one of {self.dims} "
                        "or pass an xarray-style (dim, values) tuple")
                self.coords[k] = Coord(cdims, arr)
        self.attrs = dict(attrs or {})
        self.name = name

    # -- basic introspection ------------------------------------------------
    @property
    def shape(self):
        return np.shape(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self):
        return len(self.dims)

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def values(self):
        return self.data

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        coords = ", ".join(
            f"{k}{list(c.dims)}" for k, c in self.coords.items()
        )
        return (
            f"<xmhw_tpu.DataArray {self.name or ''}{dict(self.sizes)} "
            f"coords: {coords}>"
        )

    def __getitem__(self, key):
        if isinstance(key, str):
            c = self.coords[key]
            return DataArray(
                _coord_values(c) if isinstance(c.values, TimeIndex)
                else c.values,
                c.dims, attrs=c.attrs, name=key,
            )
        raise KeyError(key)

    def get_index(self, dim):
        """Return the coordinate values labeling ``dim``."""
        c = self.coords.get(dim)
        if c is None or c.dims != (dim,):
            raise KeyError(f"no index for dim {dim!r}")
        return c.values

    def copy(self, data=None):
        return DataArray(
            self.data if data is None else data,
            self.dims,
            {k: c.copy() for k, c in self.coords.items()},
            dict(self.attrs),
            self.name,
        )

    # -- exporters (reference users consume xarray/pandas downstream) --------
    def to_xarray(self, decode_times=True):
        """This array as an ``xarray.DataArray`` (requires xarray)."""
        from .export import to_xarray

        return to_xarray(self, decode_times=decode_times)

    def to_dataframe(self):
        """This array as a ``pandas.DataFrame`` (requires pandas)."""
        from .export import to_dataframe

        return to_dataframe(self)

    # -- arithmetic (used for coldSpells negation) ---------------------------
    def __neg__(self):
        return self.copy(data=-self.data)

    def __mul__(self, other):
        return self.copy(data=self.data * other)

    __rmul__ = __mul__

    # -- selection ------------------------------------------------------------
    def isel(self, **indexers):
        """Integer-position selection along named dims."""
        sl = [slice(None)] * self.ndim
        for dim, idx in indexers.items():
            sl[self.dims.index(dim)] = idx
        data = self.data[tuple(sl)]
        new_dims = []
        for d, s in zip(self.dims, (sl[i] for i in range(self.ndim))):
            if isinstance(s, (int, np.integer)):
                continue
            new_dims.append(d)
        coords = {}
        for k, c in self.coords.items():
            if not c.dims:
                coords[k] = c.copy()
                continue
            csl = [indexers.get(d, slice(None)) for d in c.dims]
            vals = c.values[tuple(csl)] if len(csl) > 1 else c.values[csl[0]]
            cdims = tuple(d for d, s in zip(c.dims, csl)
                          if not isinstance(s, (int, np.integer)))
            from .timeutils import TimeIndex as _TI
            if not cdims and isinstance(vals, _TI):
                # scalar selection of a TimeIndex coord yields the
                # underlying timestamp, not a length-1 TimeIndex
                vals = np.asarray(vals.values).reshape(-1)[0]
            coords[k] = Coord(cdims, vals, c.attrs)
        return DataArray(data, new_dims, coords, dict(self.attrs), self.name)

    def sel(self, **indexers):
        """Label-based selection (exact values or slices)."""
        from .timeutils import TimeIndex

        iidx = {}
        for dim, label in indexers.items():
            raw = self.coords[dim].values
            vals = _coord_values(self.coords[dim])
            synth = (isinstance(raw, TimeIndex)
                     and not np.issubdtype(np.asarray(raw.values).dtype,
                                           np.datetime64))
            if synth and isinstance(label, slice) and (
                    isinstance(label.start, str)
                    or isinstance(label.stop, str)):
                # synthetic calendars (noleap/360_day/...) hold raw CF
                # offsets; date-STRING bounds are matched on decoded
                # calendar fields, end-inclusive like xarray partial
                # string indexing ("1983" -> through 31 Dec 1983)
                ymd = (raw.year.astype(np.int64) * 10000
                       + raw.month.astype(np.int64) * 100 + raw.day)

                def _enc(s, is_stop):
                    p = [int(x) for x in str(s).split("-")[:3]]
                    y = p[0]
                    mo = p[1] if len(p) > 1 else (12 if is_stop else 1)
                    d = p[2] if len(p) > 2 else (99 if is_stop else 1)
                    return y * 10000 + mo * 100 + d

                lo = 0 if label.start is None else int(np.searchsorted(
                    ymd, _enc(label.start, False), side="left"))
                hi = len(ymd) if label.stop is None else int(
                    np.searchsorted(ymd, _enc(label.stop, True),
                                    side="right"))
                iidx[dim] = slice(lo, hi)
                continue
            if isinstance(label, slice):
                start, stop = label.start, label.stop
                va = np.asarray(vals)
                desc = len(va) > 1 and va[0] > va[-1]
                is_dt = np.issubdtype(va.dtype, np.datetime64)
                # non-datetime coords: xarray label slices are stop-INCLUSIVE,
                # so an exact-match stop label must be kept (side="right").
                # Datetime bounds are pre-incremented to the next period
                # start below, so side="left" is the inclusive choice there.
                stop_side = "right"
                start_side = "right"  # descending: first element <= start
                if is_dt:
                    stop_side = "left"
                    if desc:
                        # bounds in coord order: start is the LATER
                        # period — a partial date string selects through
                        # its END (exclusive next-period bound); stop is
                        # the EARLIER period — from its START
                        start_side = "left"
                        if start is not None:
                            start = (np.datetime64(start)
                                     + 1).astype("datetime64[ns]")
                        stop = (None if stop is None
                                else np.datetime64(stop))
                    else:
                        start = (None if start is None
                                 else np.datetime64(start))
                        if stop is not None:
                            # a partial date string selects through the
                            # END of that period ("2003-01" -> 31 Jan)
                            stop = (np.datetime64(stop)
                                    + 1).astype("datetime64[ns]")
                if desc:
                    # descending coords (NetCDF lat is often north-first):
                    # like xarray, bounds are given in coord order
                    # (slice(35, 15)), searched on the reversed array
                    n = len(va)
                    rev = va[::-1]
                    lo = 0 if start is None else n - int(
                        np.searchsorted(rev, start, side=start_side))
                    hi = n if stop is None else n - int(
                        np.searchsorted(rev, stop, side="left"))
                    iidx[dim] = slice(lo, hi)
                else:
                    lo = 0 if start is None else int(
                        np.searchsorted(va, start, side="left"))
                    hi = len(va) if stop is None else int(
                        np.searchsorted(va, stop, side=stop_side))
                    iidx[dim] = slice(lo, hi)
            else:
                if np.issubdtype(np.asarray(vals).dtype, np.datetime64):
                    label = np.datetime64(label)
                matches = np.nonzero(vals == label)[0]
                if len(matches) == 0:
                    raise KeyError(f"{label!r} not found in {dim!r}")
                iidx[dim] = int(matches[0])
        return self.isel(**iidx)

    # -- reshaping -------------------------------------------------------------
    def transpose(self, *order):
        perm = [self.dims.index(d) for d in order]
        return DataArray(
            np.transpose(self.data, perm), order,
            {k: c.copy() for k, c in self.coords.items()},
            dict(self.attrs), self.name,
        )

    def stack_cell(self, dims, name="cell"):
        """Stack ``dims`` (sorted) into a trailing flat dim ``name``.

        Equivalent to the reference's
        ``temp.stack(cell=(sorted(dims)), create_index=False)``
        (reference: identify.py:520): component coords become 1-D arrays
        along the new dim; no MultiIndex is created.
        """
        dims = sorted(dims)
        keep = [d for d in self.dims if d not in dims]
        order = keep + dims
        arr = np.transpose(
            self.data, [self.dims.index(d) for d in order]
        )
        lead = arr.shape[: len(keep)]
        cell_shape = arr.shape[len(keep):]
        ncell = int(np.prod(cell_shape)) if cell_shape else 1
        data = arr.reshape(lead + (ncell,))
        # broadcast component coord values over the flattened cells;
        # dims without a coordinate variable get positional labels
        # (xarray's stack(create_index=False) handles them the same way)
        sizes = dict(zip(self.dims, self.data.shape))
        mesh = np.meshgrid(
            *[_coord_values(self.coords[d]) if d in self.coords
              else np.arange(sizes[d]) for d in dims], indexing="ij"
        )
        coords = {}
        for k, c in self.coords.items():
            if not set(c.dims) & set(dims):
                coords[k] = c.copy()
        for d, m in zip(dims, mesh):
            coords[d] = Coord((name,), m.reshape(-1),
                              self.coords[d].attrs if d in self.coords else {})
        return DataArray(data, keep + [name], coords, dict(self.attrs),
                         self.name)

    # -- NaN handling -----------------------------------------------------------
    def interpolate_na(self, dim, max_gap=None):
        """Linearly fill NaN runs along ``dim``.

        Only runs of length <= ``max_gap`` (in steps) are filled, matching
        the documented intent of the reference's maxPadLength option
        (reference: xmhw.py:74-78, 159-160). Runs on device via the
        vectorized kernel (core.events.interpolate_na_device) — the
        per-cell Python loop this replaces was minutes at planet scale.
        """
        import jax.numpy as jnp

        from ..core.events import interpolate_na_device

        ax = self.dims.index(dim)
        arr = np.moveaxis(np.asarray(self.data, dtype=np.float64), ax, 0)
        flat = arr.reshape(arr.shape[0], -1)
        filled = np.asarray(
            interpolate_na_device(jnp.asarray(flat), max_gap=max_gap))
        out = np.moveaxis(filled.reshape(arr.shape), 0, ax)
        return self.copy(data=out.astype(self.data.dtype, copy=False))


class Dataset:
    """A mapping of DataArrays sharing coords, with global attrs."""

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.data_vars: dict[str, DataArray] = {}
        self.attrs = dict(attrs or {})
        self._coords: dict[str, Coord] = {}
        for k, v in (coords or {}).items():
            self._coords[k] = v.copy() if isinstance(v, Coord) else Coord(
                (k,), v)
        for k, v in (data_vars or {}).items():
            self[k] = v

    # -- mapping protocol -------------------------------------------------------
    def __setitem__(self, key, da):
        if not isinstance(da, DataArray):
            raise TypeError("Dataset values must be DataArray")
        da = da.copy()
        da.name = key
        self.data_vars[key] = da
        for ck, c in da.coords.items():
            self._coords.setdefault(ck, c.copy())

    def __getitem__(self, key):
        if key in self.data_vars:
            return self.data_vars[key]
        if key in self._coords:
            c = self._coords[key]
            return DataArray(_coord_values(c), c.dims, attrs=c.attrs,
                             name=key)
        raise KeyError(key)

    def __contains__(self, key):
        return key in self.data_vars or key in self._coords

    def __iter__(self):
        return iter(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    def items(self):
        return self.data_vars.items()

    def __getattr__(self, name):
        # guard: during unpickling/deepcopy the instance exists before
        # __init__ ran, and attribute probes (__setstate__, ...) must
        # fail fast instead of recursing through data_vars
        if name.startswith("_") or "data_vars" not in self.__dict__:
            raise AttributeError(name)
        try:
            return self.__getitem__(name)
        except KeyError:
            raise AttributeError(name)

    @property
    def coords(self):
        return self._coords

    @property
    def dims(self):
        sizes = {}
        for da in self.data_vars.values():
            sizes.update(da.sizes)
        return sizes

    def __repr__(self):
        lines = [f"<xmhw_tpu.Dataset dims={self.dims}>"]
        for k, v in self.data_vars.items():
            lines.append(f"  {k} {v.dims} {v.shape}")
        return "\n".join(lines)

    def copy(self):
        ds = Dataset(attrs=dict(self.attrs))
        ds._coords = {k: c.copy() for k, c in self._coords.items()}
        for k, v in self.data_vars.items():
            ds.data_vars[k] = v.copy()
        return ds

    def sel(self, **indexers):
        ds = Dataset(attrs=dict(self.attrs))
        for k, v in self.data_vars.items():
            applicable = {d: s for d, s in indexers.items() if d in v.dims}
            ds[k] = v.sel(**applicable) if applicable else v.copy()
        return ds

    def isel(self, **indexers):
        ds = Dataset(attrs=dict(self.attrs))
        for k, v in self.data_vars.items():
            applicable = {d: s for d, s in indexers.items() if d in v.dims}
            ds[k] = v.isel(**applicable) if applicable else v.copy()
        return ds

    def merge(self, other):
        ds = self.copy()
        for k, v in other.data_vars.items():
            ds[k] = v
        ds.attrs.update(other.attrs)
        return ds

    def to_netcdf(self, path, **kwargs):
        from .netcdf import save_dataset

        save_dataset(self, path, **kwargs)

    def to_xarray(self, decode_times=True):
        """This dataset as an ``xarray.Dataset`` (requires xarray) — the
        same object shape the reference returns (xmhw.py:210-214)."""
        from .export import to_xarray

        return to_xarray(self, decode_times=decode_times)

    def to_dataframe(self):
        """This dataset as a ``pandas.DataFrame`` (requires pandas)."""
        from .export import to_dataframe

        return to_dataframe(self)


def grid_positions(cell_coords, out_name_dims):
    """Flat grid index per stacked cell, plus the unstacked axes.

    Returns (flat_pos (ncell,) int64, {dim: unique_sorted_labels},
    grid_shape).
    """
    uniques = {}
    pos = {}
    for d in out_name_dims:
        labels = np.asarray(cell_coords[d])
        u, inv = np.unique(labels, return_inverse=True)
        uniques[d] = u
        pos[d] = inv
    grid_shape = tuple(len(uniques[d]) for d in out_name_dims)
    flat_pos = np.ravel_multi_index(
        tuple(pos[d] for d in out_name_dims), grid_shape
    )
    return flat_pos, uniques, grid_shape


def _fill_like(dtype, fill):
    """(storage dtype, fill value) for scattering into a padded grid."""
    if np.issubdtype(dtype, np.datetime64):
        return dtype, np.datetime64("NaT")
    if np.issubdtype(dtype, np.floating):
        return dtype, fill
    return np.result_type(dtype, np.float64), fill


def unstack_cell(data, cell_coords, out_name_dims, fill=np.nan):
    """Scatter a trailing flat ``cell`` axis back onto the label grid.

    Parameters
    ----------
    data: np.ndarray (..., ncell)
    cell_coords: dict dim -> 1-D label array per cell (len ncell)
    out_name_dims: ordered list of dims to unstack into

    Returns (full_array, {dim: unique_sorted_labels}) — equivalent to
    xarray's ``unstack('cell')`` after a create_index=False stack
    (reference: xmhw.py:213-214 via set_xindex + unstack).
    """
    from .alloc import alloc_filled

    flat_pos, uniques, grid_shape = grid_positions(cell_coords,
                                                   out_name_dims)
    lead = data.shape[:-1]
    out_dtype, fill_v = _fill_like(data.dtype, fill)
    out = alloc_filled(lead + grid_shape, fill_v, out_dtype)
    out_flat = out.reshape(lead + (int(np.prod(grid_shape)),))
    out_flat[..., flat_pos] = data
    return out_flat.reshape(lead + grid_shape), uniques
