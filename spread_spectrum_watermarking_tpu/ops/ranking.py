"""Coefficient ranking: energy metrics + top-k index selection.

The reference ranks *all* W*H coefficients with a comparison sort and then
uses only the strongest N (reference: src/algorithm.rs:200-280). Only the
top-N ranks ever matter, so here this is an exact hierarchical top-k over
a vectorized metric -- O(W*H) work instead of a full O(W*H log W*H) sort,
and batched over images.

Tie-breaking parity: Rust's stable ``sort_by`` over an ascending-index list
with a descending comparator leaves ties in ascending index order
(src/algorithm.rs:204-205); every path below reproduces exactly that
(value desc, index asc) total order, including the tiled fast path (see the
proof in :func:`_tiled_exact_top_k`).

The DC coefficient (flat index 0) is always excluded, mirroring the
``.skip(1)`` at src/algorithm.rs:204 -- here via masking its metric to -inf.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Ordering


@functools.lru_cache(maxsize=64)
def _ortho_scale_map(height: int, width: int) -> np.ndarray:
    """Per-coefficient scipy-ortho rescale factor, shape (H, W).

    Reproduces ``ordering_orthogonal`` exactly (reference:
    src/algorithm.rs:240-267): a coefficient at flat index ``i`` gets
    ``(s_k0_w if i < width else s_w) * (s_k0_h if i % width == 0 else s_h)``,
    i.e. row 0 uses sqrt(1/(4W)) vs sqrt(1/(2W)), column 0 uses sqrt(1/(4H))
    vs sqrt(1/(2H)). (The reference pairs row-0 with the *width* factor and
    col-0 with the *height* factor; we keep that pairing verbatim for parity.)
    """
    s_k0_w = np.sqrt(1.0 / (4.0 * width)).astype(np.float32)
    s_w = np.sqrt(1.0 / (2.0 * width)).astype(np.float32)
    s_k0_h = np.sqrt(1.0 / (4.0 * height)).astype(np.float32)
    s_h = np.sqrt(1.0 / (2.0 * height)).astype(np.float32)

    row_factor = np.full((height, 1), s_w, dtype=np.float32)
    row_factor[0, 0] = s_k0_w  # first row (flat index < width)
    col_factor = np.full((1, width), s_h, dtype=np.float32)
    col_factor[0, 0] = s_k0_h  # first column (flat index % width == 0)
    return row_factor * col_factor


def ranking_metric(coeffs: jax.Array, ordering: Ordering) -> jax.Array:
    """Compute the per-coefficient ranking metric, shape (..., H, W).

    Larger metric == earlier rank. ENERGY is ``v*v``
    (src/algorithm.rs:214-221); ENERGY_ORTHOGONAL squares the ortho-rescaled
    value; LEGACY ranks by the raw signed rescaled value -- the preserved 2013
    bug (src/algorithm.rs:223-232).
    """
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    if ordering == Ordering.ENERGY:
        return coeffs * coeffs
    scale = jnp.asarray(_ortho_scale_map(h, w))
    scaled = coeffs * scale
    if ordering == Ordering.ENERGY_ORTHOGONAL:
        return scaled * scaled
    if ordering == Ordering.LEGACY:
        return scaled
    raise ValueError(f"unknown ordering {ordering}")


def _metric_from_values(
    vals: jax.Array,
    flat_idx: jax.Array,
    height: int,
    width: int,
    ordering: Ordering,
    size: int,
) -> jax.Array:
    """Elementwise ranking metric from coefficient values + flat indices.

    Identical to :func:`ranking_metric` but position-indexed, so it can be
    applied both as a fused virtual map over the full plane and to gathered
    candidate subsets without ever materializing a full metric array.
    DC (index 0) and padding (index >= size) are masked to -inf
    (reference DC skip: src/algorithm.rs:204).
    """
    if ordering == Ordering.ENERGY:
        m = vals * vals
    else:
        s_k0_w = np.float32(np.sqrt(1.0 / (4.0 * width)))
        s_w = np.float32(np.sqrt(1.0 / (2.0 * width)))
        s_k0_h = np.float32(np.sqrt(1.0 / (4.0 * height)))
        s_h = np.float32(np.sqrt(1.0 / (2.0 * height)))
        row_f = jnp.where(flat_idx < width, s_k0_w, s_w)
        col_f = jnp.where(flat_idx % width == 0, s_k0_h, s_h)
        scaled = vals * (row_f * col_f)
        if ordering == Ordering.ENERGY_ORTHOGONAL:
            m = scaled * scaled
        elif ordering == Ordering.LEGACY:
            m = scaled
        else:
            raise ValueError(f"unknown ordering {ordering}")
    masked = (flat_idx == 0) | (flat_idx >= size)
    return jnp.where(masked, -jnp.inf, m)


def _tiled_exact_top_k(flat: jax.Array, n: int, tile: int = 32) -> jax.Array:
    """Exact top-n indices via hierarchical tile pruning. No approximation.

    ``jax.lax.top_k`` with large n can lower to a full variadic sort of all
    W*H (value, index) pairs. This replaces it with three cheap steps that
    are *provably* equivalent, ties included:

    1. split the row into T contiguous tiles of ``tile`` elements and take
       each tile's max (one bandwidth-bound pass);
    2. stable ``top_k`` over the T tile-maxes selects n tiles (applied
       recursively when T is itself large). Proof of exactness: for any
       unselected tile U, each of the n selected tiles contributes one
       element that either beats U's max in value or ties it with a lower
       flat index (tiles are contiguous index intervals and ``top_k`` breaks
       ties toward lower tile index), so every element of U has >= n
       elements ranked above it in the reference's (value desc, index asc)
       order (src/algorithm.rs:204-205) and cannot be in the top-n;
    3. gather the n selected tiles whole (n*tile candidates) and
       lexicographically ``lax.sort`` them by (-metric, flat index) -- exactly
       the reference's descending-stable order, so even equal-valued
       coefficients land in identical rank positions.
    """
    *lead, size = flat.shape
    pad = (-size) % tile
    if pad:
        flat = jnp.concatenate(
            [flat, jnp.full((*lead, pad), -jnp.inf, flat.dtype)], axis=-1)
    t = (size + pad) // tile
    tiles = flat.reshape(*lead, t, tile)
    maxes = jnp.max(tiles, axis=-1)
    if t >= n * tile:
        tile_ids = _tiled_exact_top_k(maxes, n, tile)
    else:
        _, tile_ids = jax.lax.top_k(maxes, n)  # (..., n), stable
    cand = jnp.take_along_axis(tiles, tile_ids[..., None], axis=-2)
    offs = jnp.arange(tile, dtype=jnp.int32)
    cand_idx = tile_ids[..., None] * tile + offs  # (..., n, tile)
    cv = cand.reshape(*lead, n * tile)
    ci = cand_idx.reshape(*lead, n * tile)
    _, sorted_idx = jax.lax.sort((-cv, ci), num_keys=2, dimension=-1)
    return sorted_idx[..., :n]


def approx_top_indices(
    coeffs: jax.Array,
    n: int,
    ordering: Ordering,
    custom_metric=None,
    version: int = 2,
):
    """Fast-tier top-n: one fused bf16 metric key + ``approx_max_k``.

    Returns ``(indices, values)``: the rank-ordered flat indices AND the
    coefficient values at them. The values ride along through the re-sort so
    the pipeline never issues a second scattered gather from the full plane.

    The production (non-HIGHEST) pipelines rank on this instead of the exact
    hierarchical selection. ``jax.lax.approx_max_k`` selects approximately
    only on a TPU; on the GPU and the CPU, JAX lowers it as a sort of the
    whole row and a slice (``jax/_src/lax/ann.py``), which is an exact
    selection on the bf16 keys. Because the Writer and Reader both derive
    indices from the *base* image with this same deterministic function,
    embed/extract index agreement (the only hard correctness requirement,
    reference src/algorithm.rs:543-562) holds on one backend; across
    backends the bf16 plane itself can round differently (see
    utils/storage.py).

    Output is descending-metric ordered like the reference's full sort
    (src/algorithm.rs:204-210): the selection picks the n
    candidates on bf16 keys, then the selection is re-sorted descending with
    ascending-index tie-break -- an O(n log n) sort on n elements. At
    ``version=2`` the re-sort key is the LSB-masked bf16 magnitude
    reconstructed from the selection key itself (gather-free, see below); at
    ``version=1`` (and for custom metrics) it is the f32 metric recomputed
    from the gathered plane values. Either way the order is a deterministic
    function of the metric plane, not the reduction's bucket order. (Rank
    order across *precision tiers* still differs -- the fast tiers' plane
    carries bf16-dot rounding that reorders near-ties -- which is why write
    and read must use the same tier; the CLI records the tier in the
    watermark JSON to enforce this.)

    COMPATIBILITY CONTRACT: this function's rank order is part of the stored
    fast-tier watermark format -- a mark embedded at a fast tier is only
    readable by a build that ranks identically. ``version`` names the
    ranking generation (config.RANK_VERSION): utils/storage.py spells
    version 1 as "Default"/"High" and version 2 as "Default2"/"High2", and
    any future change to the selection or ordering must add a version (and
    spelling) rather than silently changing what an existing one means.

    ``version=1`` (legacy): selection on the plain bf16 metric keys, ONE
    gather of the n coefficient values from the plane, f32-metric re-sort.

    ``version=2``, GATHER-FREE VALUES (current): for the built-in orderings
    the plane is never gathered: the value estimate rides INSIDE the
    approx_max_k key. ENERGY / ENERGY_ORTHOGONAL order by |v| (same
    order as v^2) with the coefficient's sign bit stored in the bf16 key's
    LSB (a half-ulp perturbation of the ordering, the same class as the bf16
    key rounding itself); LEGACY orders by the signed scaled value, which IS
    the estimate. The returned key values reconstruct the signed coefficient
    estimates exactly as both the Writer and Reader will see them -- one
    more LSB of rounding on top of the plane's bf16 storage, and still a
    bit-identical function of the base image on both sides, so the estimates
    keep cancelling out of detection.
    """
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    size = h * w
    flat_c = coeffs.reshape(*coeffs.shape[:-2], size)
    neg_inf = jnp.asarray(-jnp.inf, dtype=jnp.bfloat16)
    if version not in (1, 2):
        raise ValueError(f"unknown fast-tier rank_version {version}")
    if version == 1 and custom_metric is None:
        # Legacy stored-format generation: plain bf16 metric keys, then the
        # one value gather and an f32-metric re-sort. Kept verbatim so marks
        # written as "Default"/"High" keep reading back with their original
        # tie/boundary rank order.
        m = ranking_metric(coeffs, ordering)
        keys = m.reshape(*m.shape[:-2], size).astype(jnp.bfloat16)
        keys = keys.at[..., 0].set(neg_inf)
        _, idx = jax.lax.approx_max_k(keys, n)
        cand_c = jnp.take_along_axis(flat_c, idx, axis=-1).astype(jnp.float32)
        cand_m = _metric_from_values(cand_c, idx, h, w, ordering, size)
        _, sorted_idx, sorted_vals = jax.lax.sort(
            (-cand_m, idx, cand_c), num_keys=2, dimension=-1)
        return sorted_idx, sorted_vals
    if custom_metric is not None:
        # Black-box metric: selection on bf16 keys, then the one gather.
        pos = jax.lax.broadcasted_iota(jnp.int32, (size,), 0)
        keys = custom_metric(pos, flat_c).astype(jnp.bfloat16)
        keys = keys.at[..., 0].set(neg_inf)
        _, idx = jax.lax.approx_max_k(keys, n)
        cand_c = jnp.take_along_axis(flat_c, idx, axis=-1).astype(jnp.float32)
        cand_m = custom_metric(idx, cand_c).astype(jnp.float32)
        cand_m = jnp.where(idx == 0, -jnp.inf, cand_m)  # keep DC masked
        _, sorted_idx, sorted_vals = jax.lax.sort(
            (-cand_m, idx, cand_c), num_keys=2, dimension=-1)
        return sorted_idx, sorted_vals

    if ordering == Ordering.ENERGY:
        scaled = flat_c
    else:
        scale = jnp.asarray(_ortho_scale_map(h, w)).reshape(size)
        scaled = flat_c * scale.astype(flat_c.dtype)
    if ordering == Ordering.LEGACY:
        # Signed scaled value is both the metric and (rescaled) the estimate.
        keys = scaled.astype(jnp.bfloat16)
        keys = keys.at[..., 0].set(neg_inf)
        kv, idx = jax.lax.approx_max_k(keys, n)
        sval = kv.astype(jnp.float32)
        cand_m = sval
    else:
        # |scaled| orders like scaled^2; LSB of the bf16 key carries sign.
        a = jnp.abs(scaled).astype(jnp.bfloat16)
        au = jax.lax.bitcast_convert_type(a, jnp.uint16)
        sgn = jnp.signbit(scaled).astype(jnp.uint16)
        keys = jax.lax.bitcast_convert_type(
            (au & jnp.uint16(0xFFFE)) | sgn, jnp.bfloat16)
        keys = keys.at[..., 0].set(neg_inf)
        kv, idx = jax.lax.approx_max_k(keys, n)
        ku = jax.lax.bitcast_convert_type(kv, jnp.uint16)
        mag = jax.lax.bitcast_convert_type(
            ku & jnp.uint16(0xFFFE), jnp.bfloat16).astype(jnp.float32)
        sval = jnp.where((ku & jnp.uint16(1)) != 0, -mag, mag)
        cand_m = mag
    # If n approaches the plane size the -inf-masked DC slot can be selected;
    # its key reconstructs to -inf, which would poison downstream divisions
    # (Option2/3 divide by the base value). Return 0.0 there instead -- the
    # slot still sorts last (its re-sort key cand_m stays -inf).
    sval = jnp.where(idx == 0, 0.0, sval)
    if ordering == Ordering.ENERGY:
        cand_c = sval
    else:
        scale_at = _scale_at_indices(idx, h, w)
        cand_c = sval / scale_at
    _, sorted_idx, sorted_vals = jax.lax.sort(
        (-cand_m, idx, cand_c), num_keys=2, dimension=-1)
    return sorted_idx, sorted_vals


def _scale_at_indices(flat_idx: jax.Array, height: int, width: int) -> jax.Array:
    """Ortho rescale factor at flat indices (see :func:`_ortho_scale_map`)."""
    s_k0_w = np.float32(np.sqrt(1.0 / (4.0 * width)))
    s_w = np.float32(np.sqrt(1.0 / (2.0 * width)))
    s_k0_h = np.float32(np.sqrt(1.0 / (4.0 * height)))
    s_h = np.float32(np.sqrt(1.0 / (2.0 * height)))
    row_f = jnp.where(flat_idx < width, s_k0_w, s_w)
    col_f = jnp.where(flat_idx % width == 0, s_k0_h, s_h)
    return row_f * col_f


def top_indices(
    coeffs: jax.Array,
    n: int,
    ordering: Ordering,
    exact_only: bool = False,
    custom_metric=None,
) -> jax.Array:
    """Indices (flat, row-major) of the N strongest coefficients, DC excluded.

    ``coeffs`` is (..., H, W); returns int32 (..., n) in rank order --
    equivalent to the first N entries of the reference's
    ``obtain_indices_by_function`` result (src/algorithm.rs:200-210).
    Always exact; ``exact_only`` forces the plain ``lax.top_k`` path
    (useful for A/B testing, never needed for correctness).

    The fast path never materializes the metric plane: tile maxes reduce a
    fused elementwise metric, candidates are gathered from the *coefficient*
    tiles, and the metric is re-applied to just the n*tile candidates.
    """
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    *lead, _ = coeffs.reshape(*coeffs.shape[:-2], -1).shape
    flat_c = coeffs.reshape(*lead, h * w)
    size = h * w
    tile = 32
    if custom_metric is not None:
        # Custom metric: materialize the metric plane (the callable is a
        # black box, so the fused virtual-metric trick doesn't apply), mask
        # DC, and run the exact (value desc, index asc) selection.
        pos = jax.lax.broadcasted_iota(jnp.int32, (size,), 0)
        m = custom_metric(pos, flat_c)
        neg_inf = jnp.asarray(-jnp.inf, dtype=m.dtype)
        m = m.at[..., 0].set(neg_inf)
        if exact_only or size < 4 * n * tile:
            return jax.lax.top_k(m, n)[1]
        return _tiled_exact_top_k(m, n, tile)
    if exact_only or size < 4 * n * tile:
        metric = ranking_metric(coeffs, ordering)
        flat = metric.reshape(*lead, -1)
        neg_inf = jnp.asarray(-jnp.inf, dtype=flat.dtype)
        flat = flat.at[..., 0].set(neg_inf)
        return jax.lax.top_k(flat, n)[1]

    pad = (-size) % tile
    padded = size + pad
    if pad:
        flat_c = jnp.concatenate(
            [flat_c, jnp.zeros((*lead, pad), flat_c.dtype)], axis=-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (padded,), 0)
    # Virtual metric: fused straight into the tile-max reduction below.
    metric_full = _metric_from_values(flat_c, idx, h, w, ordering, size)

    t = padded // tile
    c_tiles = flat_c.reshape(*lead, t, tile)
    maxes = jnp.max(metric_full.reshape(*lead, t, tile), axis=-1)
    if t >= n * tile:
        tile_ids = _tiled_exact_top_k(maxes, n, tile)
    else:
        _, tile_ids = jax.lax.top_k(maxes, n)
    cand_c = jnp.take_along_axis(c_tiles, tile_ids[..., None], axis=-2)
    offs = jnp.arange(tile, dtype=jnp.int32)
    cand_idx = (tile_ids[..., None] * tile + offs).reshape(*lead, n * tile)
    cand_m = _metric_from_values(
        cand_c.reshape(*lead, n * tile), cand_idx, h, w, ordering, size)
    _, sorted_idx = jax.lax.sort((-cand_m, cand_idx), num_keys=2, dimension=-1)
    return sorted_idx[..., :n]
