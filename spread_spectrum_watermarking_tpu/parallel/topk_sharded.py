"""Exact distributed top-k over sharded coefficient tiles.

The reference ranks coefficients with a serial comparison sort over all W*H
values (reference: src/algorithm.rs:200-210). Sharded, the exact global
top-n is recovered from per-shard candidates: each device takes its local
top-n, candidates are all-gathered (n * n_shards values), and a
final top-n over candidates is exact because the global top-n is a subset of
the union of per-shard top-n (SURVEY.md section 2.1).

Tie-breaking matches the single-device path (and the reference's stable
sort): candidates are compared on (metric, -global_index) so equal metrics
prefer the lower global index regardless of which shard owned them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Ordering
from ..ops.ranking import ranking_metric
from .mesh import SPATIAL_AXIS


def local_block_metric(
    coeffs_block: jax.Array,
    ordering: Ordering,
    height: int,
    width: int,
    col_offset: jax.Array,
) -> jax.Array:
    """Ranking metric for a (H, W/n) column block at ``col_offset``.

    The ortho orderings need each coefficient's *global* (row, col) position
    (reference: src/algorithm.rs:252-254), so the scale map cannot be computed
    blockwise from the local shape; we rebuild it from global coordinates.
    """
    h, wb = coeffs_block.shape[-2], coeffs_block.shape[-1]
    if ordering == Ordering.ENERGY:
        return coeffs_block * coeffs_block
    import numpy as np

    s_k0_w = np.float32(np.sqrt(1.0 / (4.0 * width)))
    s_w = np.float32(np.sqrt(1.0 / (2.0 * width)))
    s_k0_h = np.float32(np.sqrt(1.0 / (4.0 * height)))
    s_h = np.float32(np.sqrt(1.0 / (2.0 * height)))
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, wb), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, wb), 1) + col_offset
    row_f = jnp.where(rows == 0, s_k0_w, s_w)
    col_f = jnp.where(cols == 0, s_k0_h, s_h)
    scaled = coeffs_block * (row_f * col_f)
    if ordering == Ordering.ENERGY_ORTHOGONAL:
        return scaled * scaled
    if ordering == Ordering.LEGACY:
        return scaled
    raise ValueError(f"unknown ordering {ordering}")


def distributed_top_indices(
    coeffs_block: jax.Array,
    n: int,
    ordering: Ordering,
    height: int,
    width: int,
) -> jax.Array:
    """Global top-n flat indices from inside a shard_map over P(None, spatial).

    ``coeffs_block`` is this device's (Hp, Wp/n) column block of the DCT
    coefficients, where Hp/Wp may be padded up from the true ``height``/
    ``width`` for divisibility (parallel/dct_sharded.py). Returns the
    REPLICATED (n,) int32 rank-ordered global flat indices (row-major over
    the TRUE height x width image), DC and padding excluded.
    """
    axis_size = jax.lax.psum(1, SPATIAL_AXIS)
    my_id = jax.lax.axis_index(SPATIAL_AXIS)
    h, wb = coeffs_block.shape[-2], coeffs_block.shape[-1]
    col_offset = my_id * wb

    metric = local_block_metric(coeffs_block, ordering, height, width, col_offset)
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, wb), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, wb), 1) + col_offset
    gidx = rows * width + cols
    flat_metric = metric.reshape(-1)
    flat_gidx = gidx.reshape(-1)
    # DC exclusion (reference: src/algorithm.rs:204) and padding exclusion
    # (positions beyond the true height/width would otherwise alias valid
    # flat indices of later rows).
    valid = (rows < height) & (cols < width)
    neg_inf = jnp.asarray(-jnp.inf, dtype=flat_metric.dtype)
    flat_metric = jnp.where(
        (flat_gidx == 0) | ~valid.reshape(-1), neg_inf, flat_metric)

    k_local = min(n, flat_metric.shape[0])
    lv, li = jax.lax.top_k(flat_metric, k_local)
    lgi = flat_gidx[li]

    # Gather the (value, global index) candidates from every shard.
    # Each shard deposits its candidates in its slot of a zero buffer and a
    # psum combines them -- semantically an all-gather, but the psum result is
    # statically known to be replicated, which lets downstream consumers use
    # replicated out_specs.
    buf_v = jnp.zeros((axis_size, k_local), lv.dtype).at[my_id].set(lv)
    buf_i = jnp.zeros((axis_size, k_local), lgi.dtype).at[my_id].set(lgi)
    cand_v = jax.lax.psum(buf_v, SPATIAL_AXIS).reshape(-1)
    cand_i = jax.lax.psum(buf_i, SPATIAL_AXIS).reshape(-1)

    # Final exact top-n with the single-device tie rule (lower global index
    # first): sort by (-metric, index) via a stable two-key argsort.
    order = jnp.lexsort((cand_i, -cand_v))[:n]
    return cand_i[order]
