"""Full-frame 2-D DCT-II / inverse DCT-III in matmul form.

The reference performs the 2-D DCT as sequential 1-D FFT-based passes over
every row then every column (reference: src/dct2d.rs:83-219, "a pretty
non-optimised implementation that does all rows and columns in sequence",
src/dct2d.rs:6-7). Here it is dense cosine-basis matmuls:
``C_h @ X @ C_w^T`` runs on the matrix units, batches freely over images,
and lets XLA fuse the surrounding elementwise work. Basis matrices up to 4K
(4096^2 f32 = 64 MB of device memory) are cheap and cached per size.

Scaling contract (must match scipy.fftpack, reference src/dct2d.rs:105-118):

- ``DCT2`` (forward): scipy's non-ortho type-II, i.e.
  ``y_k = 2 * sum_n x_n cos(pi k (2n+1) / (2N))`` per 1-D pass.
- ``DCT2 orthogonal``: scipy's ``norm='ortho'`` -- k=0 scaled by
  sqrt(1/(4N)), k>0 by sqrt(1/(2N)) (reference: src/dct2d.rs:153-162).
- ``DCT3`` (inverse): rustdct's wiki-style DCT-III halved per pass plus a
  final global ``4/(W*H)`` correction (reference: src/dct2d.rs:109,213-218),
  so that ``idct2(dct2(x)) == x``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Precision, jax_precision


@functools.lru_cache(maxsize=64)
def dct2_basis(n: int, ortho: bool = False) -> np.ndarray:
    """Forward DCT-II basis C with C[k, m] = 2 cos(pi k (2m+1) / (2N)).

    Applying ``x @ C.T`` transforms the last axis exactly like one scipy
    ``dct(x, type=2)`` pass (the reference's per-row/col operation at
    src/dct2d.rs:141,166: rustdct output times 2).

    With ``ortho=True`` rows are rescaled to scipy's ``norm='ortho'``:
    row 0 by sqrt(1/(4N)), rows k>0 by sqrt(1/(2N))
    (reference: src/dct2d.rs:153-162).
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    c = 2.0 * np.cos(np.pi * k * (2.0 * m + 1.0) / (2.0 * n))
    if ortho:
        s = np.full((n, 1), np.sqrt(1.0 / (2.0 * n)))
        s[0, 0] = np.sqrt(1.0 / (4.0 * n))
        c = c * s
    return c.astype(np.float32)


@functools.lru_cache(maxsize=64)
def dct3_basis(n: int) -> np.ndarray:
    """Inverse (DCT-III) basis D with the reference's per-pass 0.5 scaling.

    rustdct's DCT-III is ``y_k = x_0/2 + sum_{m>=1} x_m cos(pi m (2k+1)/(2N))``
    and the reference halves every output (src/dct2d.rs:109). So
    ``D[k, 0] = 0.25`` and ``D[k, m] = 0.5 cos(pi m (2k+1) / (2N))`` for m>=1.
    The global ``4/(W*H)`` factor (src/dct2d.rs:213-218) is applied by
    :func:`idct2_2d`, not folded here, to mirror the reference's scaling
    structure.
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    d = 0.5 * np.cos(np.pi * m * (2.0 * k + 1.0) / (2.0 * n))
    d[:, 0] = 0.25
    return d.astype(np.float32)


def _fold_pass_rows(x: jax.Array, c_full: jax.Array, p) -> jax.Array:
    """One DCT-II pass contracting the -2 axis, with even/odd folding.

    Uses the cosine symmetry ``C[k, N-1-m] = (-1)^k C[k, m]``: even output
    rows contract ``x[m] + x[N-1-m]``, odd rows ``x[m] - x[N-1-m]``, so each
    matmul is (N/2 x N/2) -- half the FLOPs of the dense form. The fold adds
    one fused elementwise pass; the interleave is a free reshape of the
    stacked halves.
    """
    n = x.shape[-2]
    half = n // 2
    a = x[..., :half, :]
    b = jnp.flip(x[..., half:, :], axis=-2)
    s = a + b
    d = a - b
    ce = c_full[0::2, :half]
    co = c_full[1::2, :half]
    te = jnp.einsum("km,...mw->...kw", ce, s, precision=p)
    to = jnp.einsum("km,...mw->...kw", co, d, precision=p)
    # rows 2q <- te[q], rows 2q+1 <- to[q]
    return jnp.stack([te, to], axis=-2).reshape(*x.shape[:-2], n, x.shape[-1])


def _fold_pass_cols(x: jax.Array, c_full: jax.Array, p) -> jax.Array:
    """Same folded DCT-II pass as :func:`_fold_pass_rows`, contracting the
    last axis (no physical transpose needed)."""
    n = x.shape[-1]
    half = n // 2
    a = x[..., :half]
    b = jnp.flip(x[..., half:], axis=-1)
    s = a + b
    d = a - b
    ce = c_full[0::2, :half]
    co = c_full[1::2, :half]
    ue = jnp.einsum("...kw,lw->...kl", s, ce, precision=p)
    uo = jnp.einsum("...kw,lw->...kl", d, co, precision=p)
    return jnp.stack([ue, uo], axis=-1).reshape(*x.shape[:-1], n)


def dct2_2d(
    x: jax.Array,
    *,
    ortho: bool = False,
    precision: Precision = Precision.HIGHEST,
    fold: bool = False,
) -> jax.Array:
    """2-D DCT-II over the last two axes (..., H, W), scipy scaling.

    Equivalent to the reference's ``dct2_2d(Type::DCT2 | DCT2Orthogonal)``
    (src/dct2d.rs:83-219) but batched: leading axes are vmapped for free by
    the contraction. Row/col pass order is float-irrelevant in matmul form
    (the reference orders larger-dim-first only for scratch reuse,
    src/dct2d.rs:93-98). ``fold`` halves the matmul FLOPs for even
    dimensions via basis symmetry (see :func:`_fold_pass_rows`) but is OFF by
    default: the fold's reversal and interleave relayouts can cost more than
    the saved FLOPs. Whether it wins on the GPU is not measured.
    """
    h, w = x.shape[-2], x.shape[-1]
    ch = jnp.asarray(dct2_basis(h, ortho))
    cw = jnp.asarray(dct2_basis(w, ortho))
    p = jax_precision(precision)
    if fold and h % 2 == 0 and w % 2 == 0 and min(h, w) >= 64:
        t = _fold_pass_rows(x, ch, p)
        return _fold_pass_cols(t, cw, p)
    # Column pass: C_h @ X ; row pass: (.) @ C_w^T.
    t = jnp.einsum("km,...mw->...kw", ch, x, precision=p)
    return jnp.einsum("...kw,lw->...kl", t, cw, precision=p)


def dct2_pass(
    x: jax.Array,
    *,
    axis: int,
    ortho: bool = False,
    precision: Precision = Precision.HIGHEST,
    out_dtype=None,
) -> jax.Array:
    """One 1-D DCT-II pass along ``axis`` (-1 or -2), scipy scaling.

    Half of :func:`dct2_2d` -- exposed so pipelines can share a single pass
    between the ranking transform and the value transform (the reference runs
    the two passes back-to-back inside ``dct2_2d``, src/dct2d.rs:93-98; here
    the intermediate is a first-class value). ``out_dtype`` optionally casts
    the result (e.g. bfloat16 for a ranking-only plane).
    """
    n = x.shape[axis]
    c = jnp.asarray(dct2_basis(n, ortho))
    p = jax_precision(precision)
    if x.dtype == jnp.bfloat16:
        c = c.astype(jnp.bfloat16)
    if axis in (-2, x.ndim - 2):
        out = jnp.einsum("km,...mw->...kw", c, x, precision=p,
                         preferred_element_type=jnp.float32)
    elif axis in (-1, x.ndim - 1):
        out = jnp.einsum("...kw,lw->...kl", x, c, precision=p,
                         preferred_element_type=jnp.float32)
    else:
        raise ValueError("axis must be one of the last two axes")
    return out.astype(out_dtype) if out_dtype is not None else out


def dct2_dot_at(
    t: jax.Array,
    idx: jax.Array,
    *,
    contracted_axis: int,
    precision: Precision = Precision.HIGHEST,
) -> jax.Array:
    """Finish a 2-D DCT at selected flat indices, given one completed pass.

    ``t`` is the intermediate after :func:`dct2_pass` over ``contracted_axis``
    (-2: rows already transformed, so the remaining contraction runs over W;
    -1: the mirror). For each flat index ``i = r*W + c`` this computes
    ``coeff[r, c]`` -- the read path only ever needs coefficients at the base
    image's n ranked indices (reference: src/algorithm.rs:556-561), so the
    second full pass is wasted work.

    Formulation (fast tiers): instead of gathering ``t``'s rows per image,
    the contraction runs as one batched matmul against basis columns taken
    at the requested positions (takes from a *shared* basis vectorize across
    the batch), and the row selection happens afterwards as a one-hot masked
    reduction over the skinny (..., H, n) product -- no per-image gather.
    Whether this beats the gather+dot form on the GPU is not measured.

    At HIGHEST the gather+dot form is kept: its f32 dot contracts in one
    reduction (parity-critical last-ulp behavior), and the f32 matmul of the
    masked form would cost far more for no accuracy gain.
    """
    h = t.shape[-2]
    w = t.shape[-1]
    p = jax_precision(precision)
    if t.ndim != idx.ndim + 1:
        # Both forms below pair idx batch dims 1:1 with t's; broadcast shared
        # indices (e.g. one (n,) set across a batched t) up front so every
        # tier accepts the same shapes.
        idx = jnp.broadcast_to(idx, t.shape[:-2] + idx.shape[-1:])
    rows = idx // w
    cols = idx % w
    lead = tuple(range(t.ndim - 2))
    if contracted_axis in (-2, t.ndim - 2):
        # t = C_h @ Y; coeff[r, c] = t[r, :] . C_w[c, :]
        if precision is not Precision.HIGHEST:
            bdt = jnp.bfloat16 if precision is Precision.DEFAULT else jnp.float32
            cw_t = jnp.asarray(dct2_basis(w)).T.astype(bdt)      # (W, Kw)
            db = jnp.take(cw_t, cols, axis=1)                    # (W, ..., n)
            db = jnp.moveaxis(db, 0, -2) if db.ndim > 2 else db  # (..., W, n)
            x = jax.lax.dot_general(
                t.astype(bdt), db, (((t.ndim - 1,), (db.ndim - 2,)),
                                    (lead, lead)),
                precision=p, preferred_element_type=jnp.float32)  # (..., H, n)
            hh = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)
            # 0/1-masked reduction, NOT a dot: an einsum here would lower to
            # a DEFAULT-precision dot_general and round the f32 dot output x
            # back to bf16 before summing, discarding the f32 accumulation
            # just paid for (ADVICE r3). The where+sum is exact and fuses.
            return jnp.sum(jnp.where(rows[..., None, :] == hh, x, 0.0),
                           axis=-2)
        g = jnp.take_along_axis(t, rows[..., :, None], axis=-2)  # (..., n, W)
        cg = jnp.asarray(dct2_basis(w))[cols]  # (..., n, W)
        return jnp.einsum("...nw,...nw->...n", g, cg, precision=p,
                          preferred_element_type=jnp.float32)
    # t = Y @ C_w^T; coeff[r, c] = C_h[r, :] . t[:, c]
    if precision is not Precision.HIGHEST:
        bdt = jnp.bfloat16 if precision is Precision.DEFAULT else jnp.float32
        ch_t = jnp.asarray(dct2_basis(h)).T.astype(bdt)          # (H, Kh)
        db = jnp.take(ch_t, rows, axis=1)                        # (H, ..., n)
        db = jnp.moveaxis(db, 0, -2) if db.ndim > 2 else db      # (..., H, n)
        x = jax.lax.dot_general(
            jnp.swapaxes(t, -1, -2).astype(bdt), db,
            (((t.ndim - 1,), (db.ndim - 2,)), (lead, lead)),
            precision=p, preferred_element_type=jnp.float32)      # (..., W, n)
        ww = jax.lax.broadcasted_iota(jnp.int32, (w, 1), 0)
        # Exact masked reduction; see the mirror branch above.
        return jnp.sum(jnp.where(cols[..., None, :] == ww, x, 0.0), axis=-2)
    g = jnp.take_along_axis(t, cols[..., None, :], axis=-1)  # (..., H, n)
    cg = jnp.asarray(dct2_basis(h))[rows]  # (..., n, H)
    return jnp.einsum("...hn,...nh->...n", g, cg, precision=p,
                      preferred_element_type=jnp.float32)


def dct2_coeffs_at(
    y: jax.Array,
    idx: jax.Array,
    *,
    ortho: bool = False,
    precision: Precision = Precision.HIGHEST,
) -> jax.Array:
    """DCT-II coefficients at given flat (row-major) indices only.

    The non-blind read path needs the *derived* image's coefficients solely at
    the base image's n ranked indices (reference: src/algorithm.rs:543-562
    reads ``derived_coefficients[index]`` for the first n ranks), so the full
    second transform pass is wasted work. This computes one full 1-D pass
    along the cheaper (shorter) axis and contracts the other axis only at the
    n requested positions via a fused gather-dot:

        coeff[k, l] = C_h[k, :] @ (X @ C_w[l, :]^T)   (per index pair)

    FLOP cost ``min(H, W) / (H + W)`` of the full 2-D transform (~36% at
    1080p) plus an O(n * max(H, W)) gather-contraction. Numerically identical
    math to gathering :func:`dct2_2d`'s output (same bases, f32
    accumulation); only the contraction tiling may differ in the last ulps.

    Args:
      y: ``(..., H, W)`` luma plane(s).
      idx: ``(..., n)`` int32 flat indices (broadcast-compatible batch dims).

    Returns: ``(..., n)`` coefficients.
    """
    h, w = y.shape[-2], y.shape[-1]
    p = jax_precision(precision)
    rows = idx // w
    cols = idx % w
    if h <= w:
        ch = jnp.asarray(dct2_basis(h, ortho))
        cw = jnp.asarray(dct2_basis(w, ortho))
        # Column pass in full: (H, H) @ (..., H, W) -- the cheaper pass.
        t = jnp.einsum("km,...mw->...kw", ch, y, precision=p)
        g = jnp.take_along_axis(t, rows[..., :, None], axis=-2)  # (..., n, W)
        cg = cw[cols]  # (..., n, W)
        return jnp.einsum("...nw,...nw->...n", g, cg, precision=p)
    ch = jnp.asarray(dct2_basis(h, ortho))
    cw = jnp.asarray(dct2_basis(w, ortho))
    # Row pass in full: (..., H, W) @ (W, W)^T.
    t = jnp.einsum("...hw,lw->...hl", y, cw, precision=p)
    g = jnp.take_along_axis(t, cols[..., None, :], axis=-1)  # (..., H, n)
    cg = ch[rows]  # (..., n, H)
    return jnp.einsum("...hn,...nh->...n", g, cg, precision=p)


def _ifold_pass_rows(x: jax.Array, d_full: jax.Array, p) -> jax.Array:
    """Folded DCT-III pass over the -2 axis.

    Symmetry ``D[N-1-k, m] = (-1)^m D[k, m]``: the top half of the output is
    E + O and the bottom half the reversed E - O, where E/O contract the
    even/odd input rows -- half the FLOPs of the dense pass.
    """
    n = x.shape[-2]
    half = n // 2
    xe = x[..., 0::2, :]
    xo = x[..., 1::2, :]
    de = d_full[:half, 0::2]
    do = d_full[:half, 1::2]
    e = jnp.einsum("km,...mw->...kw", de, xe, precision=p)
    o = jnp.einsum("km,...mw->...kw", do, xo, precision=p)
    return jnp.concatenate([e + o, jnp.flip(e - o, axis=-2)], axis=-2)


def _ifold_pass_cols(x: jax.Array, d_full: jax.Array, p) -> jax.Array:
    """Folded DCT-III pass over the last axis."""
    n = x.shape[-1]
    half = n // 2
    xe = x[..., 0::2]
    xo = x[..., 1::2]
    de = d_full[:half, 0::2]
    do = d_full[:half, 1::2]
    e = jnp.einsum("...kw,lw->...kl", xe, de, precision=p)
    o = jnp.einsum("...kw,lw->...kl", xo, do, precision=p)
    return jnp.concatenate([e + o, jnp.flip(e - o, axis=-1)], axis=-1)


def idct2_2d(
    x: jax.Array,
    *,
    precision: Precision = Precision.HIGHEST,
    fold: bool = False,
) -> jax.Array:
    """Inverse of :func:`dct2_2d` (non-ortho): DCT-III passes + 4/(W*H).

    Matches the reference's ``dct2_2d(Type::DCT3)`` net scaling
    (src/dct2d.rs:109,213-218): per-pass 0.5 is folded into the basis, the
    global ``4/(W*H)`` is applied at the end. ``fold`` as in
    :func:`dct2_2d` (off by default).
    """
    h, w = x.shape[-2], x.shape[-1]
    dh = jnp.asarray(dct3_basis(h))
    dw = jnp.asarray(dct3_basis(w))
    p = jax_precision(precision)
    if fold and h % 2 == 0 and w % 2 == 0 and min(h, w) >= 64:
        t = _ifold_pass_rows(x, dh, p)
        y = _ifold_pass_cols(t, dw, p)
    else:
        t = jnp.einsum("km,...mw->...kw", dh, x, precision=p)
        y = jnp.einsum("...kw,lw->...kl", t, dw, precision=p)
    return y * (4.0 / (w * h))
