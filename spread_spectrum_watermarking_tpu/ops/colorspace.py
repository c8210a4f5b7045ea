"""Batched RGB <-> YIQ color conversion and u8 <-> f32 quantization.

Batched reimplementation of the reference's per-pixel scalar loops
(reference: src/yiq.rs:120-197) as contractions over the trailing channel
axis, which XLA fuses into neighboring elementwise work.

The conversion matrices are the Python 3.3 ``colorsys`` constants, kept
deliberately non-ITU-exact for parity with the reference
(reference: src/yiq.rs:150-165). YIQ->RGB clamps every channel to [0, 1]
(reference: src/yiq.rs:139-147,174); RGB->YIQ does not clamp.

Quantization helpers reproduce the Rust ``image`` crate's conversions exactly:
``into_rgb32f`` is u8/255, ``into_rgb8`` is round-half-away-from-zero of
clamp(x,0,1)*255 (the reference's output path, reference: examples/main.rs:278).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# colorsys forward matrix (rows: y, i, q; cols: r, g, b).
# Reference: src/yiq.rs:155-159.
RGB_TO_YIQ = np.array(
    [
        [0.30, 0.59, 0.11],
        [0.60, -0.28, -0.32],
        [0.21, -0.52, 0.31],
    ],
    dtype=np.float32,
)

# colorsys inverse matrix (rows: r, g, b; cols: y, i, q).
# Reference: src/yiq.rs:161-165.
YIQ_TO_RGB = np.array(
    [
        [1.0, 0.948262, 0.624013],
        [1.0, -0.276066, -0.639810],
        [1.0, -1.105450, 1.729860],
    ],
    dtype=np.float32,
)


def rgb_to_yiq(rgb: jax.Array) -> jax.Array:
    """Convert (..., 3) float32 RGB in [0,1] to YIQ. No clamping.

    Matches the scalar 3x3 product at reference src/yiq.rs:131-136,168-170,
    including the f32 sum order (a*r + b*g + c*b evaluated left to right).
    """
    m = jnp.asarray(RGB_TO_YIQ)
    # Left-to-right pairwise sum order mirrors the reference's
    # ``d00*v0 + d01*v1 + d02*v2``; the explicit form keeps that f32 sum
    # order on every backend.
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (m[0, 0] * r + m[0, 1] * g) + m[0, 2] * b
    i = (m[1, 0] * r + m[1, 1] * g) + m[1, 2] * b
    q = (m[2, 0] * r + m[2, 1] * g) + m[2, 2] * b
    return jnp.stack([y, i, q], axis=-1)


def rgb_to_luma(rgb: jax.Array) -> jax.Array:
    """Just the Y (luma) plane of :func:`rgb_to_yiq`: (..., 3) -> (...).

    The watermarking transform only ever reads Y (reference:
    src/algorithm.rs:330-342 operates on ``yiq.y``); computing it directly
    avoids materializing the I/Q planes on the embed/extract hot path. It is
    one contraction over the interleaved channel axis rather than strided
    per-channel slices.
    """
    m = jnp.asarray(RGB_TO_YIQ)
    return jnp.einsum("...c,c->...", rgb, m[0],
                      precision=jax.lax.Precision.HIGHEST)


def luma_diff(base: jax.Array, derived: jax.Array) -> jax.Array:
    """Luma plane of (derived - base): (..., 3) pairs -> (...).

    For u8/u8 inputs the channel difference is computed in exact integer
    arithmetic (|30 dR + 59 dG + 11 dB| <= 25500 < 2^24 is exact in f32), so
    the only rounding is the final /25500 -- strictly more accurate than
    subtracting two separately rounded lumas, because the subtraction never
    cancels. The signal the non-blind read path extracts is exactly this
    difference (reference: src/algorithm.rs:566-593, every extraction
    equation consumes ``derived - base`` or ``derived / base``).
    """
    if base.dtype == jnp.uint8 and derived.dtype == jnp.uint8:
        # Exact in f32: |channel diff| <= 255 and every product/sum stays
        # under 2^24, so the f32 arithmetic is integer-exact and the only
        # rounding is the final /25500 -- bit-identical to an int32
        # formulation. One contraction over the interleaved channel axis,
        # as in rgb_to_luma.
        d = derived.astype(jnp.float32) - base.astype(jnp.float32)
        w = jnp.asarray([30.0, 59.0, 11.0], jnp.float32)
        num = jnp.einsum("...c,c->...", d, w,
                         precision=jax.lax.Precision.HIGHEST)
        return num / 25500.0
    return rgb_to_luma(derived.astype(jnp.float32)
                       if derived.dtype != jnp.uint8 else u8_to_f32(derived)) \
        - rgb_to_luma(base.astype(jnp.float32)
                      if base.dtype != jnp.uint8 else u8_to_f32(base))


def yiq_to_rgb(yiq: jax.Array) -> jax.Array:
    """Convert (..., 3) YIQ to RGB, clamping each channel to [0, 1].

    Matches ``product_clamp`` at reference src/yiq.rs:139-147,172-175.
    """
    m = jnp.asarray(YIQ_TO_RGB)
    y, i, q = yiq[..., 0], yiq[..., 1], yiq[..., 2]
    r = (m[0, 0] * y + m[0, 1] * i) + m[0, 2] * q
    g = (m[1, 0] * y + m[1, 1] * i) + m[1, 2] * q
    b = (m[2, 0] * y + m[2, 1] * i) + m[2, 2] * q
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(rgb, 0.0, 1.0)


def u8_to_f32(rgb_u8: jax.Array) -> jax.Array:
    """u8 [0,255] -> f32 [0,1]; the ``image`` crate's ``into_rgb32f``."""
    return rgb_u8.astype(jnp.float32) / 255.0


def f32_to_u8(rgb_f32: jax.Array) -> jax.Array:
    """f32 -> u8 via clamp(x,0,1)*255 with round-half-away-from-zero.

    This is the ``image`` crate's ``NormalizeFloat`` conversion used by
    ``into_rgb8`` (the reference's save path, examples/main.rs:278). For
    non-negative inputs round-half-away-from-zero == floor(x*255 + 0.5).
    """
    x = jnp.clip(rgb_f32, 0.0, 1.0) * 255.0
    return jnp.floor(x + 0.5).astype(jnp.uint8)


def add_luma_delta_u8(rgb_u8: jax.Array, dy: jax.Array) -> jax.Array:
    """u8 RGB + luma delta -> watermarked u8 RGB, integer-domain quantize.

    Computes ``f32_to_u8(clip(u8_to_f32(rgb) + dy[..., None], 0, 1))`` -- the
    Writer's epilogue (reference: Writer::result + into_rgb8,
    src/algorithm.rs:361-379, examples/main.rs:278) -- as
    ``clamp(floor(x + 255*dy + 0.5), 0, 255)`` per channel. The two forms are
    mathematically identical for any real dy (clip-then-scale == scale-then-
    clamp around floor(.+0.5)); the arithmetic differs only in f32 rounding
    ~1e-7 relative, far below the 1/255 quantization step.

    Channel-planar formulation: each channel is sliced, updated, and the
    three results stacked, so XLA materializes no (B, H, W, 3) f32
    intermediate as it does for the broadcast form.
    """
    df = dy.astype(jnp.float32) * 255.0
    outs = [
        jnp.clip(jnp.floor(rgb_u8[..., k].astype(jnp.float32) + df + 0.5),
                 0.0, 255.0).astype(jnp.uint8)
        for k in range(3)
    ]
    return jnp.stack(outs, axis=-1)


def np_f32_to_u8(rgb_f32: np.ndarray) -> np.ndarray:
    """Host-side (numpy) version of :func:`f32_to_u8` for IO paths."""
    x = np.clip(rgb_f32, 0.0, 1.0) * 255.0
    return np.floor(x + 0.5).astype(np.uint8)


def np_u8_to_f32(rgb_u8: np.ndarray) -> np.ndarray:
    """Host-side (numpy) version of :func:`u8_to_f32` for IO paths."""
    return rgb_u8.astype(np.float32) / 255.0
