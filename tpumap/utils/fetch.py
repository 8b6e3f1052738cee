"""One-transfer device->host result fetch.

jax.device_get walks pytree leaves one by one, one transfer each.
device_fetch() bitcasts every leaf to uint8 on device, concatenates them
into ONE buffer, fetches that with a single transfer, and re-slices on
the host.  The device-side concat is one fused memcpy-shaped program, cached
per leaf-structure.
"""
from __future__ import annotations

from functools import partial

import numpy as np

_packers: dict = {}


def _get_packer(n: int):
    p = _packers.get(n)
    if p is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def pack(*leaves):
            flat = []
            for x in leaves:
                if x.dtype == jnp.bool_:
                    x = x.astype(jnp.uint8)
                b = jax.lax.bitcast_convert_type(x, jnp.uint8)
                flat.append(b.reshape(-1))
            return jnp.concatenate(flat) if len(flat) > 1 else flat[0]

        p = _packers[n] = pack
    return p


# Wire dtypes for result-dict fields: narrow types cut the bytes moved
# device->host.  Narrowing happens
# at the TOP-LEVEL jit boundary only (internal compute stays int32 —
# where()/arithmetic on narrow unsigned types wraps); the driver widens
# back to int32 right after the fetch (widen_ints) so host numpy never
# sees a narrow unsigned type.
_WIRE_DTYPES = {
    "strand": "uint8", "nmismatch": "uint16", "second_nmismatch": "uint16",
    "n_best": "uint16", "trim_qstart": "uint16", "trim_qend": "uint16",
    "trim_nmm": "uint16", "qual_mean16": "uint16",
    "in_idx": "int32", "in_startoff": "int16",
    "pe_cs1": "uint8", "pe_cs2": "uint8",
    "pe_cn1": "uint16", "pe_cn2": "uint16",
    "pe_ci": "uint8", "pe_cj": "uint8",
}


def narrow_result(d: dict) -> dict:
    """Cast known result fields to their wire dtypes (device side)."""
    import jax.numpy as jnp
    return {k: (v.astype(_WIRE_DTYPES[k]) if k in _WIRE_DTYPES else v)
            for k, v in d.items()}


def widen_ints(d: dict) -> dict:
    """Host-side inverse: upcast narrow ints to int32 so downstream numpy
    arithmetic can never wrap (uint16 - int, -1 sentinels, etc.)."""
    out = {}
    for k, v in d.items():
        if (isinstance(v, np.ndarray)
                and v.dtype in (np.uint8, np.uint16, np.int16, np.int8)):
            out[k] = v.astype(np.int32)
        else:
            out[k] = v
    return out


def device_fetch(tree):
    """Fetch a pytree of device arrays to host numpy with ONE transfer."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if not leaves:
        return tree
    import jax.numpy as jnp
    leaves = [jnp.asarray(x) for x in leaves]
    buf = np.asarray(_get_packer(len(leaves))(*leaves))
    out = []
    off = 0
    for x in leaves:
        dt = np.dtype("uint8") if x.dtype == jnp.bool_ else np.dtype(
            x.dtype.name)
        n = int(np.prod(x.shape, dtype=np.int64)) * dt.itemsize
        arr = np.frombuffer(buf, dtype=dt, count=n // dt.itemsize,
                            offset=off).reshape(x.shape)
        if x.dtype == jnp.bool_:
            arr = arr.astype(bool)
        out.append(arr)
        off += n
    return jax.tree_util.tree_unflatten(treedef, out)
