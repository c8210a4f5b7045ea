"""Modulation tests, mirroring reference src/algorithm.rs:729-863."""

import jax.numpy as jnp
import numpy as np
import pytest

from spread_spectrum_watermarking_tpu.config import Method, Ordering
from spread_spectrum_watermarking_tpu.ops import modulation, ranking


COEFFS = np.asarray([-3.0, 5.0, -8.0, 7.0, 1.0, 2.0], dtype=np.float32)


@pytest.mark.parametrize("method", list(Method))
def test_insert_extract_roundtrip(method):
    # Reference test_insert_extract_functions (src/algorithm.rs:729-763).
    mark = jnp.asarray([1.0, -0.5, 1.0, 0.5, 0.5, 0.1], dtype=jnp.float32)
    orig = jnp.asarray(COEFFS)
    embedded = modulation.insert_values(method, 0.1, orig, mark)
    extracted = np.asarray(modulation.extract_values(method, 0.1, orig, embedded))
    np.testing.assert_allclose(extracted, np.asarray(mark), atol=1e-3)


def _embed_into_coeffs(coeffs, marks):
    """Scatter-embed like the pipeline does, on a (1, 6) toy image."""
    c = jnp.asarray(coeffs)[None]  # (1, 6) as (H=1, W=6)
    idx = ranking.top_indices(c, marks.shape[-1], Ordering.ENERGY)
    flat = c.reshape(-1)
    original = flat[idx]
    new = modulation.embed_marks(original, jnp.asarray(marks), Method.OPTION2, 0.1)
    return np.asarray(flat.at[idx].set(new))


def test_embedder_single():
    # Reference test_embedder_single (src/algorithm.rs:765-801).
    mark = np.asarray([1.0, -0.5, 1.0], dtype=np.float32)
    got = _embed_into_coeffs(COEFFS, mark)
    s = 0.1
    want = [-3.0, 5.0 * (1 + 1 * s), -8.0 * (1 + 1 * s), 7.0 * (1 - 0.5 * s), 1.0, 2.0]
    np.testing.assert_allclose(got, want, rtol=1e-6)

    # Extraction recovers the mark near-exactly (no quantization here).
    c = jnp.asarray(COEFFS)[None]
    idx = ranking.top_indices(c, 3, Ordering.ENERGY)
    extracted = np.asarray(modulation.extract_values(
        Method.OPTION2, 0.1, jnp.asarray(COEFFS)[idx], jnp.asarray(got)[idx]))
    np.testing.assert_allclose(extracted, mark, atol=1e-6)


def test_embedder_single_and_zero():
    # Reference test_embedder_single_and_zero (src/algorithm.rs:803-830):
    # an all-zero second mark is a no-op under delta-additive embedding.
    marks = np.asarray([[1.0, -0.5, 1.0], [0.0, 0.0, 0.0]], dtype=np.float32)
    got = _embed_into_coeffs(COEFFS, marks)
    s = 0.1
    want = [-3.0, 5.0 * (1 + 1 * s), -8.0 * (1 + 1 * s), 7.0 * (1 - 0.5 * s), 1.0, 2.0]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_embedder_multiple_delta_additive():
    # Reference test_embedder_multiple (src/algorithm.rs:832-863): deltas are
    # computed against the ORIGINAL coefficients and summed.
    marks = np.asarray([[1.0, -0.5, 1.0], [0.5, -0.5, -1.0]], dtype=np.float32)
    got = _embed_into_coeffs(COEFFS, marks)
    s = 0.1
    v2 = -8.0 + (-8.0 * (1 + 1 * s) - -8.0) + (-8.0 * (1 + 0.5 * s) - -8.0)
    v3 = 7.0 + (7.0 * (1 - 0.5 * s) - 7.0) + (7.0 * (1 - 0.5 * s) - 7.0)
    v1 = 5.0 + (5.0 * (1 + 1 * s) - 5.0) + (5.0 * (1 - 1 * s) - 5.0)
    np.testing.assert_allclose(got, [-3.0, v1, v2, v3, 1.0, 2.0], rtol=1e-6)


def test_similarity_statistic():
    # sim = e.c / sqrt(e.e) (src/algorithm.rs:696-714); identical marks of
    # length N give sim = sqrt(N * mean(e^2)) ~ sqrt(N) for N(0,1).
    rng = np.random.default_rng(0)
    e = rng.standard_normal((1, 1000)).astype(np.float32)
    sim_self = np.asarray(modulation.similarity(jnp.asarray(e), jnp.asarray(e)))[0, 0]
    want = (e[0] @ e[0]) / np.sqrt(e[0] @ e[0])
    np.testing.assert_allclose(sim_self, want, rtol=1e-5)
    # Batched sweep equals per-pair loop.
    cands = rng.standard_normal((7, 1000)).astype(np.float32)
    sweep = np.asarray(modulation.similarity(jnp.asarray(e), jnp.asarray(cands)))[0]
    for k in range(7):
        want_k = (e[0] @ cands[k]) / np.sqrt(e[0] @ e[0])
        np.testing.assert_allclose(sweep[k], want_k, rtol=1e-4, atol=1e-4)


def test_exceeds_sigma_is_strict_greater():
    sim = jnp.asarray([5.999, 6.0, 6.001])
    got = np.asarray(modulation.exceeds_sigma(sim, 6.0))
    np.testing.assert_array_equal(got, [False, False, True])


def test_similarity_fast_precisions_preserve_detection():
    # The sweep's precision knob (ops/modulation.similarity) trades matmul
    # exactness for rate on large database screens. The perturbation of
    # the sigma statistic must stay far below any detection threshold; on
    # the CPU every precision is f32, and chip_smoke.py prints the card's
    # error for a 1024x10k sweep.
    import jax

    rng = np.random.default_rng(3)
    ext = jnp.asarray(rng.standard_normal((64, 1000)).astype(np.float32))
    marks = jnp.asarray(rng.standard_normal((256, 1000)).astype(np.float32))
    hi = np.asarray(modulation.similarity(ext, marks))
    for prec, bound in ((jax.lax.Precision.HIGH, 1e-3),
                        (jax.lax.Precision.DEFAULT, 5e-2)):
        lo = np.asarray(modulation.similarity(ext, marks, precision=prec))
        assert np.abs(lo - hi).max() < bound, prec
