"""End-to-end jitted watermarking pipelines (the framework's "models").

Each public function is one pure, batched, jittable program over
``(B, H, W, 3)`` image arrays -- the whole reference call stack between
``into_rgb32f`` and ``into_rgb8`` (reference: src/algorithm.rs:295-379 Writer,
:462-562 Reader, call stacks in SURVEY.md section 3) compiled as a single XLA
computation: colorspace -> DCT -> rank -> modulate -> inverse DCT ->
colorspace, with batching and sharding handled by JAX instead of
one-image-at-a-time object state.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import Method, Precision, ReadConfig, WriteConfig, jax_precision
from ..ops import colorspace, dct, modulation, ranking


def _to_f32(rgb: jax.Array) -> jax.Array:
    if jnp.issubdtype(rgb.dtype, jnp.integer):
        return colorspace.u8_to_f32(rgb)
    return rgb.astype(jnp.float32)


def _forward(rgb: jax.Array, precision) -> jax.Array:
    """RGB (..., H, W, 3) -> Y-channel DCT coefficients (..., H, W).

    The shared prologue of Writer and Reader (reference:
    src/algorithm.rs:308-313, 476-480). Only the luma plane is ever
    transformed, so I/Q are never computed here.
    """
    return dct.dct2_2d(
        colorspace.rgb_to_luma(_to_f32(rgb)), precision=precision)


def _sparse_idct_delta(
    delta: jax.Array,
    idx: jax.Array,
    h: int,
    w: int,
    precision,
) -> jax.Array:
    """Inverse-DCT of a sparse coefficient update, as a skinny matmul.

    The embedding touches only the top-n coefficients, so instead of a full
    inverse transform of the modified plane (2 dense W*H matmuls, the
    reference's Writer::result path at src/algorithm.rs:361-374) we invert
    just the delta:

        dY = (4/(W*H)) * D_h[:, rows] @ diag(delta) @ D_w[:, cols]^T

    an (H, n) @ (n, W) matmul -- ~3x fewer FLOPs at n=1000/1080p, and MORE
    accurate than the reference's round trip because unmodified pixels never
    pass through DCT->IDCT at all.

    ``delta``: (B, n) coefficient changes; ``idx``: (B, n) flat indices.
    Returns (B, H, W) luma deltas.
    """
    dh = jnp.asarray(dct.dct3_basis(h))  # (H, H): dh[k, m]
    dw = jnp.asarray(dct.dct3_basis(w))
    p = jax_precision(precision)
    rows = idx // w
    cols = idx % w
    # jnp.take with batched indices gives (H, B, n); normalize to (B, H, n).
    a = jnp.take(dh, rows, axis=1)  # D_h columns at each row index
    a = jnp.moveaxis(a, 0, 1) if a.ndim == 3 else a
    b = jnp.take(dw, cols, axis=1)
    b = jnp.moveaxis(b, 0, 1) if b.ndim == 3 else b
    scaled = a * delta[..., None, :]  # (B, H, n) * (B, 1, n)
    if precision is Precision.DEFAULT:
        # The fast tiers invert the delta on bf16 operands: storing the
        # gathered factors as bf16 halves their device-memory round trip
        # (~24 MB/img at 1080p). The scale factor is folded in BEFORE the
        # bf16 rounding of ``scaled``.
        scaled = (scaled * (4.0 / (w * h))).astype(jnp.bfloat16)
        # dY is an alpha-scale perturbation (~2e-3); bf16 storage noise on it
        # (~0.4% relative = ~8e-6 absolute) is far below the 1/255 output
        # quantization step, and halves the plane's round trip. The bf16
        # output must be requested FROM the dot (f32 accumulate, round on
        # emit -- same values as astype'ing an f32 result): a separate
        # .astype lets XLA fold the convert into the consumer fusion and
        # materialize the full f32 plane anyway.
        return jnp.einsum("...hn,...wn->...hw", scaled,
                          b.astype(jnp.bfloat16), precision=p,
                          preferred_element_type=jnp.bfloat16)
    out = jnp.einsum("...hn,...wn->...hw", scaled, b, precision=p)
    return out * (4.0 / (w * h))


def _batched_gather(flat: jax.Array, idx: jax.Array) -> jax.Array:
    return jnp.take_along_axis(flat, idx, axis=-1)


def _batched_scatter(flat: jax.Array, idx: jax.Array, values: jax.Array) -> jax.Array:
    # Top-k indices are distinct, so a plain scatter-set is well defined.
    if flat.ndim == 1:
        return flat.at[idx].set(values, mode="promise_in_bounds")
    b = flat.shape[0]
    rows = jnp.arange(b, dtype=idx.dtype)[:, None]
    return flat.at[rows, idx].set(values, mode="promise_in_bounds")


def _batched_scatter_add(flat: jax.Array, idx: jax.Array,
                         values: jax.Array) -> jax.Array:
    if flat.ndim == 1:
        return flat.at[idx].add(values, mode="promise_in_bounds")
    b = flat.shape[0]
    rows = jnp.arange(b, dtype=idx.dtype)[:, None]
    return flat.at[rows, idx].add(values, mode="promise_in_bounds")


def _shorter_axis(h: int, w: int) -> int:
    """Axis whose 1-D pass is cheaper to run in full: contract the shorter
    dimension first (mirrors the reference's larger-dim-first scratch-reuse
    ordering, src/dct2d.rs:93-98, but chosen here to minimize the full-pass
    FLOPs that the value path shares)."""
    return -2 if h <= w else -1


def _half_pass(rgb: jax.Array, precision, ax: int) -> jax.Array:
    """Luma + one DCT-II pass along ``ax``. At DEFAULT precision the pass
    runs as a single bf16 dot on a bf16 luma plane (bf16 T storage); at HIGH
    as an f32-operand dot at ``lax.Precision.HIGH`` (TF32 on an H100).
    ``ax`` is always the shorter image axis (:func:`_shorter_axis`).

    Writer and Reader must rank through the SAME plane (near-tie rank
    agreement), so any other formulation of this pass has to serve both.
    """
    y = colorspace.rgb_to_luma(_to_f32(rgb))
    if precision is Precision.DEFAULT:
        return dct.dct2_pass(y.astype(jnp.bfloat16), axis=ax,
                             precision=Precision.DEFAULT,
                             out_dtype=jnp.bfloat16)
    return dct.dct2_pass(y, axis=ax, precision=precision)


def _second_pass(t: jax.Array, ax: int) -> jax.Array:
    """The fast tiers' second DCT pass: a single bf16 dot (f32 accumulate,
    bf16 emit) over the axis :func:`_half_pass` did not contract. This IS
    the plane the fast tiers rank on -- one definition shared by
    :func:`_rank_from_half` and the :func:`rank_plane` inspection view."""
    other = -1 if ax == -2 else -2
    return dct.dct2_pass(
        t if t.dtype == jnp.bfloat16 else t.astype(jnp.bfloat16),
        axis=other, precision=Precision.DEFAULT, out_dtype=jnp.bfloat16)


def _rank_and_values_fast(
    rgb: jax.Array,
    n: int,
    ordering,
    precision,
    custom_metric=None,
    rank_version: int = 2,
) -> Tuple[jax.Array, jax.Array]:
    """Production prologue: ranked indices + coefficient values, delta-exact.

    Computes the full coefficient plane in two dot passes (the second always
    a single bf16 dot with f32 accumulation), ranks it with
    :func:`..ops.ranking.approx_top_indices` (``approx_max_k``: a sort and
    slice of the bf16 keys on the GPU), and reads
    the n touched values (reference: src/algorithm.rs:382-410 writes,
    :543-562 reads) with one flat gather -- no gather-dot reconstruction.

    The values carry the plane's bf16-dot rounding (~0.4% relative). That is
    exact *by construction* for detection: the Writer embeds
    ``delta = vals_est * alpha * w`` and the Reader divides the recovered
    delta by the bit-identical ``vals_est`` (same function of the same base
    image), so the estimate cancels out of the extracted mark entirely --
    only u8 quantization noise remains, same as the reference-exact path.
    See :func:`_extract_fast` for the matching delta-side read.

    vs the reference's Writer/Reader prologue (full f32 transform + full
    comparison sort over W*H, src/algorithm.rs:308-342, 200-210): the same
    two-pass structure, but bf16 dots, ``approx_max_k`` selection on bf16
    keys, and no gather from the plane.
    """
    h, w = rgb.shape[-3], rgb.shape[-2]
    ax = _shorter_axis(h, w)
    t = _half_pass(rgb, precision, ax)
    return _rank_from_half(t, n, ordering, custom_metric, ax, rank_version)


def _rank_from_half(t: jax.Array, n: int, ordering, custom_metric,
                    ax: int, rank_version: int = 2,
                    ) -> Tuple[jax.Array, jax.Array]:
    """Second DCT pass + ranking, from a half-transformed plane.

    Split out of :func:`_rank_and_values_fast` so every consumer of the fast
    prologue (including the staged pipeline, parallel/pipeline_staged.py)
    shares one definition of the plane numerics -- Writer/Reader/stage
    agreement is bit-exact because this IS the same code.

    bf16 plane storage: the plane only feeds bf16 ranking keys and the
    value estimates that cancel out of detection, so rounding its
    f32-accumulated dot output to bf16 halves the largest intermediate
    on the path (16.6 -> 8.3 MB/img at 1080p) without touching the
    quality-gate statistics. The re-sort/metric math upcasts the n gathered
    values back to f32 (ops/ranking.approx_top_indices).
    """
    plane = _second_pass(t, ax)
    with jax.named_scope("ssw.rank"):
        idx, vals = ranking.approx_top_indices(plane, n, ordering,
                                               custom_metric=custom_metric,
                                               version=rank_version)
    return idx, vals


def _embed_fast(rgb: jax.Array, marks: jax.Array, config: WriteConfig,
                quantize: bool) -> jax.Array:
    """Fast embed path (non-HIGHEST precisions): two-pass bf16 transform +
    sparse everything. Same algorithm as :func:`embed`'s reference-exact
    path; the transform/ranking internals trade exact tie order and some
    boundary rank selections (bf16 keys) for throughput, and
    the bf16 value estimates cancel out of detection entirely (see
    :func:`_rank_and_values_fast`). Writer and Reader agree exactly because
    both derive indices and values from the base image with the same
    deterministic code."""
    n = marks.shape[-1]
    h, w = rgb.shape[-3], rgb.shape[-2]
    with jax.named_scope("ssw.forward"):
        idx, original = _rank_and_values_fast(
            rgb, n, config.ordering, config.precision, config.custom_ordering,
            config.rank_version)
    if marks.ndim == 2:  # (M, N) shared across batch -> (B, M, N)
        marks = jnp.broadcast_to(marks[None],
                                 (original.shape[0],) + marks.shape)
    new_values = modulation.embed_marks(
        original, marks, config.insertion.method, config.insertion.alpha,
        custom_insert=config.custom_insert, indices=idx,
    )
    with jax.named_scope("ssw.inverse"):
        # Y is the only modified plane and the Y column of YIQ->RGB is
        # [1,1,1] (src/yiq.rs:161-165), so RGB' = clamp(RGB + dY).
        # The delta IDCT runs single-pass bf16: dy is itself a ~alpha-scale
        # perturbation, so bf16's ~0.4% relative error on it is ~0.04% of
        # the watermark signal -- invisible in sim (31.25 vs 31.24 sigma on
        # the cat-image gate).
        delta = new_values - original
        dy = _sparse_idct_delta(delta, idx, h, w, Precision.DEFAULT)
        if quantize and rgb.dtype == jnp.uint8:
            # Channel-planar integer-domain quantize (see
            # colorspace.add_luma_delta_u8).
            return colorspace.add_luma_delta_u8(rgb, dy)
        out = jnp.clip(_to_f32(rgb) + dy[..., None], 0.0, 1.0)
    return colorspace.f32_to_u8(out) if quantize else out


def _extract_fast_tail(base: jax.Array, derived: jax.Array, idx: jax.Array,
                       base_vals: jax.Array, config: ReadConfig,
                       sparse_second: bool = True) -> jax.Array:
    """Delta-exact read tail given the base's ranked indices/values.

    The derived image is never transformed on its own: every extraction
    equation consumes ``derived - base`` (or their ratio, reference
    src/algorithm.rs:566-593), and the DCT is linear, so the numerator is
    computed by transforming ``luma(derived) - luma(base)`` directly. On
    that delta signal a single-pass bf16 transform is accurate to ~0.4%
    *of the delta* -- the catastrophic-cancellation risk of subtracting two
    separately-computed large coefficient sets (where bf16 rounding of the
    operands is ~4x the signal) disappears, which is what lets the whole
    read path run at bf16 speed with reference-grade output.
    """
    h, w = base.shape[-3], base.shape[-2]
    ax = _shorter_axis(h, w)
    ydiff = colorspace.luma_diff(base, derived)
    td = dct.dct2_pass(ydiff.astype(jnp.bfloat16), axis=ax,
                       precision=Precision.DEFAULT,
                       out_dtype=jnp.bfloat16)
    if sparse_second:
        # The delta plane is only ever read at the n ranked indices, so the
        # second pass is a gather-dot over n rows instead of a full matmul
        # (~0.05% of the full pass's FLOPs at 1080p/n=1000; reference reads
        # derived coefficients the same sparse way, src/algorithm.rs:556-561).
        num = dct.dct2_dot_at(td, idx, contracted_axis=ax,
                              precision=Precision.DEFAULT)
    else:
        other = -1 if ax == -2 else -2
        dplane = dct.dct2_pass(td, axis=other, precision=Precision.DEFAULT)
        num = _batched_gather(dplane.reshape(*dplane.shape[:-2], h * w), idx)
    if config.custom_extract is not None:
        # Custom closures see (idx, base, derived) like the reference's
        # Extraction::Custom (src/algorithm.rs:123); the derived values are
        # reconstructed as base + delta (differences exact, ratios to the
        # plane's bf16-dot tolerance).
        return config.custom_extract(idx, base_vals, base_vals + num)
    method, alpha = config.extraction.method, config.extraction.alpha
    if method == Method.OPTION1:  # (d - b) / alpha
        return num / alpha
    if method == Method.OPTION2:  # (d - b) / (b * alpha)
        return num / (base_vals * alpha)
    if method == Method.OPTION3:  # ln(d / b) / alpha = log1p(num / b) / alpha
        return jnp.log1p(num / base_vals) / alpha
    raise ValueError(f"unknown method {method}")


def _extract_fast(base: jax.Array, derived: jax.Array, n: int,
                  config: ReadConfig, sparse_second: bool = True) -> jax.Array:
    """Fast read path (non-HIGHEST): rank from the base, transform the diff.

    The base prologue is shared bit-for-bit with :func:`_embed_fast` (the
    dispatch keys on the base image alone, so Writer and Reader always rank
    through the same code path); see :func:`_extract_fast_tail` for the
    delta-exact numerator.
    """
    with jax.named_scope("ssw.forward"):
        idx, base_vals = _rank_and_values_fast(
            base, n, config.ordering, config.precision,
            config.custom_ordering, config.rank_version)
        return _extract_fast_tail(base, derived, idx, base_vals, config,
                                  sparse_second)


@functools.partial(jax.jit, static_argnames=("config", "quantize", "sparse_idct"))
def embed(
    rgb: jax.Array,
    marks: jax.Array,
    config: WriteConfig = WriteConfig(),
    quantize: bool = True,
    sparse_idct: bool = True,
) -> jax.Array:
    """Embed watermark(s) into a batch of images.

    Args:
      rgb: ``(B, H, W, 3)`` or ``(H, W, 3)``, uint8 or float32 in [0, 1].
      marks: ``(N,)`` single mark, ``(M, N)`` M marks shared across the batch,
        or ``(B, M, N)`` per-image marks. Multi-mark embedding is
        delta-additive (reference: src/algorithm.rs:382-410).
      config: insertion method/alpha + ordering (reference WriteConfig,
        src/algorithm.rs:99-112).
      quantize: if True, return uint8 (the reference's ``into_rgb8`` path);
        else float32 RGB.
      sparse_idct: invert only the n modified coefficients via the skinny
        matmul (default, faster and more accurate); False forces the
        reference-style full inverse transform of the modified plane. At the
        fast (non-HIGHEST) tiers ranking still runs through the fast
        prologue either way -- the Reader ranks there, and Writer/Reader
        rank agreement is the hard invariant -- so False only changes the
        inverse-transform shape (and, at those tiers, adds the full round
        trip's bf16 reconstruction noise to unmodified pixels; prefer the
        default).

    Returns: watermarked images, same leading shape as ``rgb``.
    """
    single_image = rgb.ndim == 3
    if single_image:
        rgb = rgb[None]
    if marks.ndim == 1:
        marks = marks[None]
    n = marks.shape[-1]

    if config.precision is not Precision.HIGHEST:
        if sparse_idct:
            # Production path: shared half-pass, metric-only rank plane,
            # bf16-key ranking, all-sparse value/inverse work.
            out = _embed_fast(rgb, marks, config, quantize)
            return out[0] if single_image else out
        # Fast tier + forced full inverse. Ranking MUST still run through
        # the fast prologue: the fast Reader always ranks via
        # approx_top_indices on the bf16 half-pass plane, and Writer/Reader
        # rank agreement is the one hard correctness invariant (reference:
        # src/algorithm.rs:462-498 -- the reader re-derives the writer's
        # ordering). Ranking this branch exactly (as it did before round 4)
        # embedded marks the fast Reader could not detect: 2.29 sigma vs
        # 31.88 on the cat image at DEFAULT. The SAME
        # delta the sparse path embeds is scatter-ADDED into the full
        # coefficient plane (add, not set: the plane's own value at idx is
        # the tier's full-transform coefficient, not the prologue's bf16
        # estimate, and detection recovers the delta against the estimate),
        # then the reference-style full inverse transform runs at the
        # requested tier (src/algorithm.rs:361-374).
        with jax.named_scope("ssw.forward"):
            idx, original = _rank_and_values_fast(
                rgb, n, config.ordering, config.precision,
                config.custom_ordering, config.rank_version)
        if marks.ndim == 2:
            marks = jnp.broadcast_to(marks[None],
                                     (original.shape[0],) + marks.shape)
        new_values = modulation.embed_marks(
            original, marks, config.insertion.method, config.insertion.alpha,
            custom_insert=config.custom_insert, indices=idx)
        rgbf = _to_f32(rgb)
        yiq = colorspace.rgb_to_yiq(rgbf)
        h, w = rgb.shape[-3], rgb.shape[-2]
        coeffs = dct.dct2_2d(yiq[..., 0], precision=config.precision)
        flat = _batched_scatter_add(
            coeffs.reshape(coeffs.shape[0], -1), idx, new_values - original)
        with jax.named_scope("ssw.inverse"):
            y = dct.idct2_2d(flat.reshape(-1, h, w),
                             precision=config.precision)
            out = colorspace.yiq_to_rgb(
                jnp.concatenate([y[..., None], yiq[..., 1:]], axis=-1))
        if quantize:
            out = colorspace.f32_to_u8(out)
        return out[0] if single_image else out

    with jax.named_scope("ssw.forward"):
        rgbf = _to_f32(rgb)
        y_in = colorspace.rgb_to_luma(rgbf)
        coeffs = dct.dct2_2d(y_in, precision=config.precision)
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    with jax.named_scope("ssw.rank"):
        idx = ranking.top_indices(coeffs, n, config.ordering,
                                  custom_metric=config.custom_ordering)

    flat = coeffs.reshape(coeffs.shape[0], -1)
    original = _batched_gather(flat, idx)
    if marks.ndim == 2:  # (M, N) shared across batch -> (B, M, N)
        marks = jnp.broadcast_to(marks[None], (flat.shape[0],) + marks.shape)
    new_values = modulation.embed_marks(
        original, marks, config.insertion.method, config.insertion.alpha,
        custom_insert=config.custom_insert, indices=idx,
    )

    if sparse_idct:
        # Only Y changes, and the Y column of YIQ_TO_RGB is exactly
        # [1, 1, 1] (R = Y + ..i.. + ..q.., reference src/yiq.rs:161-165),
        # so RGB' = clamp(RGB + dY) -- the I/Q planes and the output 3x3
        # conversion drop out of the computation entirely.
        with jax.named_scope("ssw.inverse"):
            dy = _sparse_idct_delta(
                new_values - original, idx, h, w, config.precision)
            out = jnp.clip(rgbf + dy[..., None], 0.0, 1.0)
    else:
        yiq = colorspace.rgb_to_yiq(rgbf)
        flat = _batched_scatter(flat, idx, new_values)
        y = dct.idct2_2d(flat.reshape(-1, h, w), precision=config.precision)
        out = colorspace.yiq_to_rgb(
            jnp.concatenate([y[..., None], yiq[..., 1:]], axis=-1))
    if quantize:
        out = colorspace.f32_to_u8(out)
    if single_image:
        out = out[0]
    return out


@functools.partial(jax.jit, static_argnames=("config", "quantize"))
def embed_verified(
    rgb: jax.Array,
    marks: jax.Array,
    config: WriteConfig = WriteConfig(),
    quantize: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Embed and immediately verify, sharing the base prologue: one program.

    Returns ``(marked, extracted)`` where ``extracted`` is what
    :func:`extract` would recover from the quantized output -- the
    round-trip the reference CLI's ``-p`` flag performs with a full second
    Writer/Reader derivation (examples/main.rs:306-316). Here the base
    image's forward transform and ranking are computed ONCE and reused by
    the read tail (legitimately: a Reader re-deriving them from the same
    base image at the same tier produces bit-identical values), so the
    verify costs only the diff transform + gather-dot on top of the embed.

    Extraction inverts ``config.insertion`` (Option1/2/3). Custom insert
    closures have no derivable inverse -- unsupported here; use
    :func:`embed` + :func:`extract` with an explicit ``custom_extract``.
    """
    if config.custom_insert is not None:
        raise ValueError("embed_verified cannot invert a custom_insert; "
                         "use embed + extract with custom_extract")
    single_image = rgb.ndim == 3
    if single_image:
        rgb = rgb[None]
    if marks.ndim == 1:
        marks = marks[None]
    n = marks.shape[-1]
    rconfig = ReadConfig(
        extraction=config.insertion, ordering=config.ordering,
        precision=config.precision, custom_ordering=config.custom_ordering)

    if config.precision is not Precision.HIGHEST:
        with jax.named_scope("ssw.forward"):
            idx, original = _rank_and_values_fast(
                rgb, n, config.ordering, config.precision,
                config.custom_ordering, config.rank_version)
        marks_b = (jnp.broadcast_to(marks[None],
                                    (original.shape[0],) + marks.shape)
                   if marks.ndim == 2 else marks)
        new_values = modulation.embed_marks(
            original, marks_b, config.insertion.method,
            config.insertion.alpha, indices=idx)
        with jax.named_scope("ssw.inverse"):
            delta = new_values - original
            h, w = rgb.shape[-3], rgb.shape[-2]
            dy = _sparse_idct_delta(delta, idx, h, w, Precision.DEFAULT)
            if quantize and rgb.dtype == jnp.uint8:
                marked = colorspace.add_luma_delta_u8(rgb, dy)
            else:
                marked = jnp.clip(_to_f32(rgb) + dy[..., None], 0.0, 1.0)
                if quantize:
                    marked = colorspace.f32_to_u8(marked)
        ext = _extract_fast_tail(rgb, marked, idx, original, rconfig)
    else:
        marked = embed(rgb, marks, config, quantize=quantize)
        coeffs = _forward(rgb, config.precision)
        idx = ranking.top_indices(coeffs, n, config.ordering,
                                  custom_metric=config.custom_ordering)
        base_vals = _batched_gather(coeffs.reshape(coeffs.shape[0], -1), idx)
        yd = colorspace.rgb_to_luma(_to_f32(marked))
        derived_vals = dct.dct2_coeffs_at(yd, idx, precision=config.precision)
        ext = modulation.extract_values(
            rconfig.extraction.method, rconfig.extraction.alpha,
            base_vals, derived_vals)
    if single_image:
        return marked[0], ext[0]
    return marked, ext


@functools.partial(jax.jit, static_argnames=("config", "n"))
def prepare_base(
    rgb: jax.Array,
    n: int,
    config: ReadConfig = ReadConfig(),
) -> Tuple[jax.Array, jax.Array]:
    """Forward-transform the base (original) image and rank its coefficients.

    Equivalent to ``Reader::base`` (reference: src/algorithm.rs:462-498).
    Returns ``(flat_coefficients, top_n_indices)``; cache this to amortize the
    base transform across many derived images (the reference CLI's extraction
    cache, examples/main.rs:369-412).
    """
    single_image = rgb.ndim == 3
    if single_image:
        rgb = rgb[None]
    coeffs = _forward(rgb, config.precision)
    idx = ranking.top_indices(coeffs, n, config.ordering,
                              custom_metric=config.custom_ordering)
    flat = coeffs.reshape(coeffs.shape[0], -1)
    if single_image:
        return flat[0], idx[0]
    return flat, idx


@functools.partial(jax.jit, static_argnames=("config",))
def prepare_derived(
    rgb: jax.Array,
    config: ReadConfig = ReadConfig(),
) -> jax.Array:
    """Forward-transform a derived (watermarked) image: coefficients only.

    Equivalent to ``Reader::derived`` (reference: src/algorithm.rs:469-480) --
    no ordering, no extraction config.
    """
    single_image = rgb.ndim == 3
    if single_image:
        rgb = rgb[None]
    coeffs = _forward(rgb, config.precision)
    flat = coeffs.reshape(coeffs.shape[0], -1)
    return flat[0] if single_image else flat


@functools.partial(jax.jit, static_argnames=("config",))
def extract_prepared(
    base_flat: jax.Array,
    idx: jax.Array,
    derived_flat: jax.Array,
    config: ReadConfig = ReadConfig(),
) -> jax.Array:
    """Extract mark values given prepared base/derived coefficients.

    Vectorized form of ``Reader::extract_watermark``
    (reference: src/algorithm.rs:543-562): gather both coefficient sets at the
    ranked indices and invert the embedding equation.

    Quality note: subtracting two independently transformed planes is only
    meaningful when both were computed at ``Precision.HIGHEST`` (f32-exact
    transforms). At the fast tiers each plane carries ~0.4% relative bf16-dot
    rounding -- several times the watermark delta itself -- so use
    :func:`rank_base` + :func:`extract_ranked` there instead (delta-exact).
    """
    base_vals = _batched_gather(base_flat, idx)
    derived_vals = _batched_gather(derived_flat, idx)
    if config.custom_extract is not None:
        return config.custom_extract(idx, base_vals, derived_vals)
    return modulation.extract_values(
        config.extraction.method, config.extraction.alpha, base_vals, derived_vals
    )


@functools.partial(jax.jit, static_argnames=("config", "n"))
def rank_base(
    rgb: jax.Array,
    n: int,
    config: ReadConfig = ReadConfig(),
) -> Tuple[jax.Array, jax.Array]:
    """Rank the base image's coefficients on the fast (non-HIGHEST) path.

    The fast-tier analog of :func:`prepare_base` -- ``Reader::base``
    (reference: src/algorithm.rs:462-498) -- returning ``(indices,
    base_values)`` from the same prologue :func:`embed`'s fast path uses, so
    a Reader built from this cache agrees bit-for-bit with the Writer. Cache
    the result to amortize the base transform across many derived images
    (the reference CLI's extraction cache, examples/main.rs:369-412); pair
    with :func:`extract_ranked`, which needs the base *pixels* (not a
    coefficient plane) for the delta-exact numerator.
    """
    single_image = rgb.ndim == 3
    if single_image:
        rgb = rgb[None]
    idx, vals = _rank_and_values_fast(
        rgb, n, config.ordering, config.precision, config.custom_ordering,
        config.rank_version)
    if single_image:
        return idx[0], vals[0]
    return idx, vals


@functools.partial(jax.jit, static_argnames=("precision",))
def rank_plane(
    rgb: jax.Array,
    precision: Precision = Precision.HIGHEST,
) -> jax.Array:
    """The (H, W) coefficient plane the given tier actually ranks on.

    Inspection view backing ``Writer.coefficients()``/``Reader`` accessors
    (reference: ``Writer::coefficient_image``/``Reader::coefficients``,
    src/algorithm.rs:319-321, 502-504). At HIGHEST this is the exact f32
    forward transform; at the fast tiers it is the SAME bf16 two-pass plane
    the production prologue ranks (:func:`_second_pass` of
    :func:`_half_pass`), returned as f32 -- so the top-n positions of this
    plane's ranking metric are the indices :func:`embed`/:func:`extract`
    actually use at that tier. (Round-3 accessors always returned the
    HIGHEST-style plane; at DEFAULT its top-1000 overlapped the embedded
    indices only 789/1000.)
    """
    single_image = rgb.ndim == 3
    if single_image:
        rgb = rgb[None]
    if precision is Precision.HIGHEST:
        out = _forward(rgb, precision)
    else:
        h, w = rgb.shape[-3], rgb.shape[-2]
        ax = _shorter_axis(h, w)
        out = _second_pass(_half_pass(rgb, precision, ax),
                           ax).astype(jnp.float32)
    return out[0] if single_image else out


@functools.partial(jax.jit, static_argnames=("config",))
def extract_ranked(
    base: jax.Array,
    derived: jax.Array,
    idx: jax.Array,
    base_vals: jax.Array,
    config: ReadConfig = ReadConfig(),
) -> jax.Array:
    """Extract given cached :func:`rank_base` output (fast tiers).

    Unlike :func:`extract_prepared` (which consumes two independently
    transformed coefficient planes and is only meaningful at
    ``Precision.HIGHEST``, where the transforms are f32-exact), this
    delta-exact form transforms ``luma(derived) - luma(base)`` so the fast
    tiers' bf16 plane rounding cancels out of detection entirely.
    """
    single_image = base.ndim == 3
    if single_image:
        base, derived = base[None], derived[None]
        idx, base_vals = idx[None], base_vals[None]
    out = _extract_fast_tail(base, derived, idx, base_vals, config)
    return out[0] if single_image else out


@functools.partial(jax.jit, static_argnames=("config", "n", "sparse_second"))
def _extract_fused(
    base: jax.Array,
    derived: jax.Array,
    n: int,
    config: ReadConfig,
    sparse_second: bool = True,
) -> jax.Array:
    """Fused read path: full transform of base, sparse transform of derived.

    The base image needs its full coefficient plane (the ranking metric reads
    every coefficient), but the derived image's coefficients are only ever
    read at the base's n ranked indices (reference: src/algorithm.rs:556-561),
    so its transform runs through :func:`..ops.dct.dct2_coeffs_at` -- one
    1-D pass plus a gather-dot instead of a second full pass.
    """
    if config.precision is not Precision.HIGHEST:
        return _extract_fast(base, derived, n, config, sparse_second)
    coeffs = _forward(base, config.precision)
    idx = ranking.top_indices(coeffs, n, config.ordering,
                              custom_metric=config.custom_ordering)
    flat = coeffs.reshape(coeffs.shape[0], -1)
    base_vals = _batched_gather(flat, idx)
    yd = colorspace.rgb_to_luma(_to_f32(derived))
    derived_vals = dct.dct2_coeffs_at(yd, idx, precision=config.precision)
    if config.custom_extract is not None:
        return config.custom_extract(idx, base_vals, derived_vals)
    return modulation.extract_values(
        config.extraction.method, config.extraction.alpha, base_vals, derived_vals
    )


def extract(
    base: jax.Array,
    derived: jax.Array,
    n: int,
    config: ReadConfig = ReadConfig(),
    sparse_derived: bool = True,
) -> jax.Array:
    """Extract length-``n`` watermark(s): full read path, batched.

    ``base`` and ``derived`` are ``(B, H, W, 3)`` or ``(H, W, 3)`` images.
    ``config.precision`` must be the tier the watermark was EMBEDDED at:
    the fast tiers' rank order is deterministic per tier but reorders
    near-tie energies across tiers, so reading at a different tier scrambles
    the mark-element pairing (the CLI records the tier in the watermark
    JSON for exactly this reason; see README "Precision tiers").
    ``sparse_derived`` (default) computes the derived image's coefficients
    only at the n ranked indices (a cheaper read path); False
    forces the reference-style full second transform (at fast tiers: a full
    second pass of the delta plane instead of the gather-dot -- the
    delta-exact construction is not optional there, see
    :func:`_extract_fast_tail`).
    Raises ValueError on the conditions the reference panics on
    (src/algorithm.rs:550-555): mismatched image sizes, or ``n`` not below
    the coefficient count (the reference's check is ``>=``, off-by-one
    included, so ``n`` must be strictly less than W*H).
    """
    if base.shape != derived.shape:
        raise ValueError(
            "Derived coefficient length not equal to base coefficient length: "
            f"base {base.shape} vs derived {derived.shape}"
        )
    h, w = base.shape[-3], base.shape[-2]
    if n >= h * w:
        raise ValueError("Desired extraction length exceeds available coefficients.")
    if sparse_derived or config.precision is not Precision.HIGHEST:
        single_image = base.ndim == 3
        if single_image:
            base, derived = base[None], derived[None]
        out = _extract_fused(base, derived, n, config,
                             sparse_second=sparse_derived)
        return out[0] if single_image else out
    base_flat, idx = prepare_base(base, n, config)
    derived_flat = prepare_derived(derived, config)
    return extract_prepared(base_flat, idx, derived_flat, config)


similarity = jax.jit(modulation.similarity)
