"""spread_spectrum_watermarking_tpu: spread-spectrum image watermarking in JAX.

A from-scratch JAX/XLA implementation of the non-blind spread-spectrum
image watermarking algorithm of Cox, Kilian, Leighton & Shamoon (IEEE Trans.
Image Processing 6(12), 1997; patent US5930369), with the same capabilities as
the reference Rust crate ``iwanders/spread_spectrum_watermarking`` -- but
functional, batched, and sharded from day one.

Pipeline (reference: src/lib.rs:10-16):
  RGB -> YIQ; 2-D DCT of the Y channel; rank coefficients by energy; modulate
  an N(0,1) watermark into the N strongest via the patent's step-42 equations;
  inverse DCT; YIQ -> RGB. Detection extracts X* using the original image and
  tests ``sim(X, X*) = X*.X / sqrt(X*.X*)`` against a sigma threshold.

Public surface:
  - Functional (preferred): :func:`embed`, :func:`extract`, :func:`similarity`,
    plus :func:`prepare_base`/:func:`prepare_derived`/:func:`extract_prepared`
    for amortizing the base transform.
  - Reference-shaped wrappers: :class:`Writer`, :class:`Reader`,
    :class:`Tester` (cf. reference src/lib.rs:81-85).
  - Configs: :class:`WriteConfig`, :class:`ReadConfig`, :class:`InsertExtract`,
    :class:`Method`, :class:`Ordering`, :class:`Precision`.
  - Marks: :func:`generate_normal` (jax.random) and
    :mod:`~spread_spectrum_watermarking_tpu.utils.rng_compat` for
    reference-bit-compatible seeded sequences.
"""

from .api import Reader, ReaderDerived, Similarity, Tester, Writer
from .config import (
    RANK_VERSION,
    InsertExtract,
    Method,
    Ordering,
    Precision,
    ReadConfig,
    WriteConfig,
)
from .marks import as_marks, generate_normal
from .models.pipeline import (
    embed,
    embed_verified,
    extract,
    extract_prepared,
    extract_ranked,
    prepare_base,
    prepare_derived,
    rank_base,
    rank_plane,
    similarity,
)

__version__ = "0.1.0"

__all__ = [
    "Writer", "Reader", "ReaderDerived", "Tester", "Similarity",
    "WriteConfig", "ReadConfig", "InsertExtract", "Method", "Ordering",
    "Precision",
    "embed", "embed_verified", "extract", "similarity",
    "prepare_base", "prepare_derived", "extract_prepared",
    "rank_base", "extract_ranked", "rank_plane", "RANK_VERSION",
    "generate_normal", "as_marks",
]
