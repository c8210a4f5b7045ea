"""Plain float64 reference of the watermarking algorithm (numpy + scipy).

The reference algorithm re-implemented from its spec in float64 numpy +
``scipy.fftpack`` (the library the reference's DCT is defined against,
src/dct2d.rs:229-241): colorsys YIQ, full-frame scipy DCT-II, stable
(energy desc, index asc) ranking with DC skipped, Option2 embed at
alpha=0.1, exact inverse, u8 round-half-away quantization. It shares no
code with the JAX pipeline, so the tests and ``chip_smoke.py`` compare the
pipeline against it on identical pixels.
"""

from __future__ import annotations

import numpy as np

N = 1000


def forward(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 -> float64 scipy DCT-II of the luma plane."""
    from scipy import fftpack

    f = img_u8.astype(np.float64) / 255.0
    y = 0.30 * f[..., 0] + 0.59 * f[..., 1] + 0.11 * f[..., 2]
    return fftpack.dct(fftpack.dct(y, type=2, axis=0), type=2, axis=1)


def embed(base_u8: np.ndarray, mark64: np.ndarray, n: int = N, order=None):
    """Option2 embed of a length-``n`` mark. Returns ``(marked_u8, order)``,
    ``order`` being the ``n`` ranked flat indices: the oracle's own ranking,
    or the one passed in (to compare arithmetic apart from near-tie rank
    order)."""
    from scipy import fftpack

    h, w = base_u8.shape[:2]
    coeffs = forward(base_u8)
    flat = coeffs.reshape(-1)
    if order is None:
        order = np.lexsort((np.arange(flat.size), -(flat**2)))
        order = order[order != 0][:n]  # DC skip (src/algorithm.rs:204)
    order = np.asarray(order)
    f = base_u8.astype(np.float64) / 255.0
    i_p = 0.60 * f[..., 0] - 0.28 * f[..., 1] - 0.32 * f[..., 2]
    q_p = 0.21 * f[..., 0] - 0.52 * f[..., 1] + 0.31 * f[..., 2]
    flat2 = flat.copy()
    flat2[order] = flat[order] * (1.0 + 0.1 * mark64)  # Option2
    y2 = fftpack.idct(
        fftpack.idct(flat2.reshape(h, w), type=2, axis=1), type=2, axis=0
    ) / (4.0 * h * w)
    rgb = np.stack([
        y2 + 0.948262 * i_p + 0.624013 * q_p,
        y2 - 0.276066 * i_p - 0.639810 * q_p,
        y2 - 1.105450 * i_p + 1.729860 * q_p,
    ], axis=-1)
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.floor(rgb * 255.0 + 0.5).astype(np.uint8), order


def extract(base_u8: np.ndarray, derived_u8: np.ndarray,
            order: np.ndarray) -> np.ndarray:
    """Option2 extraction at the given ranked indices."""
    b = forward(base_u8).reshape(-1)
    d = forward(derived_u8).reshape(-1)
    return (d[order] - b[order]) / (0.1 * b[order])


def sim(e: np.ndarray, m: np.ndarray) -> float:
    """Cox et al. detection statistic ``e.m / sqrt(e.e)``."""
    return float(e.dot(m) / np.sqrt(e.dot(e)))
