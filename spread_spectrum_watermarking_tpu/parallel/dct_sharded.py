"""Spatially-sharded 2-D DCT for images too large for one chip.

The separable 2-D DCT over a row-sharded image needs a reshard between the
row pass and the column pass: each device transforms its rows locally, then
an all-to-all (the image-domain analog of Ulysses-style sequence-parallel
attention) re-tiles the array column-sharded so the column pass is also
local. This is the component the reference's sequential double loop
(reference: src/dct2d.rs:128-207) becomes when a 4K+ image is spread over a
slice (SURVEY.md sections 2.1, 5 "long-context analog").

Arbitrary (non-divisible) image sizes are supported the way the reference
supports any W x H (reference: src/dct2d.rs:83-98): the array is zero-padded
up to the next multiple of the spatial axis size and the cosine bases are
zero-extended, so padding contributes exactly nothing to any output
coefficient; results are cropped back. The ``*_padded`` variants expose the
padded layout for pipelines that keep intermediate stages sharded.

Data layout: input (H, W) sharded P(spatial, None); output (H, W) sharded
P(None, spatial). The inverse takes the column-sharded layout back to
row-sharded, so a full embed round trip ends in the input layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import Precision, jax_precision
from ..ops.dct import dct2_basis, dct3_basis
from .mesh import SPATIAL_AXIS


def padded_size(size: int, n: int) -> int:
    """Smallest multiple of ``n`` that is >= ``size``."""
    return -(-size // n) * n


@functools.lru_cache(maxsize=64)
def _dct2_basis_padded(n: int, n_pad: int, ortho: bool = False) -> np.ndarray:
    """Forward basis zero-extended to (n_pad, n_pad): rows/cols >= n are zero,
    so padded inputs contribute nothing and padded outputs are zero."""
    c = np.zeros((n_pad, n_pad), dtype=np.float32)
    c[:n, :n] = dct2_basis(n, ortho)
    return c


@functools.lru_cache(maxsize=64)
def _dct3_basis_padded(n: int, n_pad: int) -> np.ndarray:
    d = np.zeros((n_pad, n_pad), dtype=np.float32)
    d[:n, :n] = dct3_basis(n)
    return d


@functools.lru_cache(maxsize=8)
def replicated_basis(kind: str, n: int, n_pad: int, mesh: Mesh,
                     ortho: bool = False) -> jax.Array:
    """A zero-extended (n_pad, n_pad) basis (``kind`` "dct2" or "dct3") on
    every device of ``mesh``.

    The sharded programs take their bases as arguments: captured inside a
    jit they would be compiled in as constants, 155 MB at 4K and 620 MB at
    8K per program, in every executable and compile-cache entry.
    """
    basis = (_dct2_basis_padded(n, n_pad, ortho) if kind == "dct2"
             else _dct3_basis_padded(n, n_pad))
    return jax.device_put(basis, NamedSharding(mesh, P()))


def _pad_last2(x: jax.Array, hp: int, wp: int) -> jax.Array:
    h, w = x.shape[-2], x.shape[-1]
    if h == hp and w == wp:
        return x
    cfg = [(0, 0)] * (x.ndim - 2) + [(0, hp - h), (0, wp - w)]
    return jnp.pad(x, cfg)


def dct2_2d_sharded_padded(
    y_padded: jax.Array,
    mesh: Mesh,
    bases,
    *,
    precision: Precision = Precision.HIGHEST,
) -> jax.Array:
    """Forward sharded DCT on an already-padded (..., Hp, Wp) array.

    ``bases`` is ``(ch, cw)``, the "dct2" bases of :func:`replicated_basis`
    for the true (pre-pad) height and width; the padded region must be zero
    on input and is zero on output. In P(spatial, None) -> out
    P(None, spatial).
    """
    hp, wp = y_padded.shape[-2], y_padded.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    assert hp % n == 0 and wp % n == 0, (hp, wp, n)
    ch, cw = bases
    p = jax_precision(precision)

    def local(y_blk, ch_full, cw_full):
        # Row pass on the local row block: (Hp/n, Wp) @ (Wp, Wp)^T.
        t = jnp.einsum("...hw,lw->...hl", y_blk, cw_full, precision=p)
        # Reshard rows->columns (all-to-all): (Hp/n, Wp) -> (Hp, Wp/n).
        t = jax.lax.all_to_all(t, SPATIAL_AXIS, split_axis=t.ndim - 1,
                               concat_axis=t.ndim - 2, tiled=True)
        # Column pass, local on the column block: (Hp, Hp) @ (Hp, Wp/n).
        return jnp.einsum("km,...mw->...kw", ch_full, t, precision=p)

    spec_in = P(*([None] * (y_padded.ndim - 2)), SPATIAL_AXIS, None)
    spec_out = P(*([None] * (y_padded.ndim - 2)), None, SPATIAL_AXIS)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_in, P(None, None), P(None, None)),
        out_specs=spec_out,
    )(y_padded, ch, cw)


def idct2_2d_sharded_padded(
    x_padded: jax.Array,
    mesh: Mesh,
    height: int,
    width: int,
    bases,
    *,
    precision: Precision = Precision.HIGHEST,
) -> jax.Array:
    """Inverse sharded DCT on a padded (..., Hp, Wp) coefficient array.

    In P(None, spatial) -> out P(spatial, None); valid region [:height, :width].
    ``bases`` is ``(dh, dw)``, the "dct3" bases of :func:`replicated_basis`.
    """
    hp, wp = x_padded.shape[-2], x_padded.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    assert hp % n == 0 and wp % n == 0, (hp, wp, n)
    dh, dw = bases
    p = jax_precision(precision)
    scale = 4.0 / (width * height)

    def local(x_blk, dh_full, dw_full):
        # Column pass on the local column block: (Hp, Hp) @ (Hp, Wp/n).
        t = jnp.einsum("km,...mw->...kw", dh_full, x_blk, precision=p)
        # Reshard columns->rows: (Hp, Wp/n) -> (Hp/n, Wp).
        t = jax.lax.all_to_all(t, SPATIAL_AXIS, split_axis=t.ndim - 2,
                               concat_axis=t.ndim - 1, tiled=True)
        # Row pass local: (Hp/n, Wp) @ (Wp, Wp)^T, then the global correction.
        return jnp.einsum("...hw,lw->...hl", t, dw_full, precision=p) * scale

    spec_in = P(*([None] * (x_padded.ndim - 2)), None, SPATIAL_AXIS)
    spec_out = P(*([None] * (x_padded.ndim - 2)), SPATIAL_AXIS, None)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_in, P(None, None), P(None, None)),
        out_specs=spec_out,
    )(x_padded, dh, dw)


def dct2_2d_sharded(
    y: jax.Array,
    mesh: Mesh,
    *,
    ortho: bool = False,
    precision: Precision = Precision.HIGHEST,
) -> jax.Array:
    """Forward sharded DCT-II: in P(spatial, None) -> out P(None, spatial).

    Scaling identical to :func:`..ops.dct.dct2_2d` (scipy non-ortho or ortho).
    Any (H, W) is accepted; non-divisible sizes are padded internally and
    cropped on return.
    """
    h, w = y.shape[-2], y.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    hp, wp = padded_size(h, n), padded_size(w, n)
    bases = (replicated_basis("dct2", h, hp, mesh, ortho),
             replicated_basis("dct2", w, wp, mesh, ortho))
    out = dct2_2d_sharded_padded(
        _pad_last2(y, hp, wp), mesh, bases, precision=precision)
    return out[..., :h, :w] if (hp, wp) != (h, w) else out


def idct2_2d_sharded(
    x: jax.Array,
    mesh: Mesh,
    *,
    precision: Precision = Precision.HIGHEST,
) -> jax.Array:
    """Inverse sharded DCT: in P(None, spatial) -> out P(spatial, None)."""
    h, w = x.shape[-2], x.shape[-1]
    n = mesh.shape[SPATIAL_AXIS]
    hp, wp = padded_size(h, n), padded_size(w, n)
    bases = (replicated_basis("dct3", h, hp, mesh),
             replicated_basis("dct3", w, wp, mesh))
    out = idct2_2d_sharded_padded(
        _pad_last2(x, hp, wp), mesh, h, w, bases, precision=precision)
    return out[..., :h, :w] if (hp, wp) != (h, w) else out
