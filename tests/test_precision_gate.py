"""Quality gate at the benchmark's precision setting.

bench.py (the driver's headline) runs ``precision="default"``, which takes
the fast production path: shared half-pass transform, bf16 metric-only rank
plane, ``approx_max_k`` ranking, sparse bf16 delta-IDCT
(models/pipeline.py:_embed_fast/_extract_fast). Round 1 benched this setting
without any correctness evidence at it;
these tests pin detection quality at both fast tiers to the
HIGHEST-precision reference-parity path -- fixed-seed absolute bounds below,
and a PAIRED same-seed fast-vs-HIGHEST comparison over 8 seeds
(test_fast_tier_paired_with_highest) gating the actual fast-tier claim:
the bf16 estimates cancel out of detection, so the fast tiers sit within
measured noise of the exact path seed by seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spread_spectrum_watermarking_tpu as wm
from spread_spectrum_watermarking_tpu.config import (Precision, ReadConfig,
                                                     WriteConfig)
from spread_spectrum_watermarking_tpu.utils import rng_compat

N = 1000


def _roundtrip_sim(cat, mark, precision):
    wcfg = WriteConfig(precision=precision)
    rcfg = ReadConfig(precision=precision)
    marked = np.asarray(wm.embed(jnp.asarray(cat), jnp.asarray(mark), wcfg))
    ext = np.asarray(wm.extract(jnp.asarray(cat), jnp.asarray(marked), N, rcfg))
    sim = float(np.asarray(
        wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0])
    return marked, ext, sim


@pytest.mark.parametrize("precision", [Precision.HIGH, Precision.DEFAULT])
def test_fast_path_self_similarity_at_benched_precision(cat_image, precision):
    mark = rng_compat.generate_fixed_normal_sequence(1, N)
    _, ext, sim = _roundtrip_sim(cat_image, mark, precision)
    _, _, sim_exact = _roundtrip_sim(cat_image, mark, Precision.HIGHEST)
    # Reference bound (tests/single_simple.rs:78-79) AND agreement with the
    # exact path within 1 sigma.
    assert sim > 31.2, sim
    assert abs(sim - sim_exact) < 1.0, (sim, sim_exact)
    # Per-coefficient error is gated by the PAIRED test below (the absolute
    # 0.02-grade bound is pinned seed-robustly at HIGHEST by
    # tests/test_parity.py; a single-seed absolute envelope here hid more
    # than it gated).
    # Null hypothesis unchanged at the fast setting.
    null = rng_compat.generate_fixed_normal_sequence(0xBAAAAAAD, N)
    nsim = float(np.asarray(
        wm.similarity(jnp.asarray(ext), jnp.asarray(null[None])))[0])
    assert abs(nsim) < 2.0, nsim


@pytest.mark.parametrize("precision", [Precision.HIGH, Precision.DEFAULT])
def test_fast_tier_paired_with_highest(cat_image, precision):
    """Same-seed paired comparison over 8 seeds: the fast tier must track
    HIGHEST within measured noise ON EVERY SEED, and show no systematic
    degradation in the mean -- the gate the round-3 0.05 absolute envelope
    could not provide (a fast-path change degrading detection by 2x relative
    to HIGHEST would have passed it; it fails this).

    Measured envelope (CPU harness, 8 seeds, both tiers): per-seed
    |dsim| <= 0.041, mean dsim -0.005; per-seed |d err_mean| <= 0.0184
    (one heavy-tail seed where u8 rounding residues land on small
    coefficients), mean d err_mean +0.002. Bounds are ~5x the measured
    extremes.
    """
    S = 8
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(123), N, count=S))
    batch = jnp.asarray(np.broadcast_to(cat_image, (S,) + cat_image.shape))

    def run(prec):
        wcfg = WriteConfig(precision=prec)
        rcfg = ReadConfig(precision=prec)
        marked = wm.embed(batch, jnp.asarray(marks[:, None, :]), wcfg)
        ext = np.asarray(wm.extract(batch, marked, N, rcfg))
        sims = np.einsum("sn,sn->s", ext, marks) / np.sqrt(
            np.einsum("sn,sn->s", ext, ext))
        return sims, np.abs(ext - marks).mean(axis=1)

    sims_f, errs_f = run(precision)
    sims_x, errs_x = run(Precision.HIGHEST)
    dsim = sims_f - sims_x
    derr = errs_f - errs_x
    assert np.abs(dsim).max() < 0.25, dsim
    assert dsim.mean() > -0.05, dsim
    assert np.abs(derr).max() < 0.08, derr
    assert derr.mean() < 0.008, derr


@pytest.mark.parametrize("precision", [Precision.HIGH, Precision.DEFAULT])
def test_fast_path_attacks_at_benched_precision(cat_image, precision):
    from PIL import Image

    mark = rng_compat.generate_fixed_normal_sequence(2, N)
    wcfg = WriteConfig(precision=precision)
    rcfg = ReadConfig(precision=precision)
    marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), wcfg))
    h, w = cat_image.shape[:2]

    im = Image.fromarray(marked)
    restored = np.asarray(
        im.resize((w // 8, h // 8), Image.BICUBIC).resize((w, h), Image.BICUBIC))
    ext = np.asarray(wm.extract(
        jnp.asarray(cat_image), jnp.asarray(restored), N, rcfg))
    sim_resize = float(np.asarray(
        wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0])
    assert sim_resize > 9.5, sim_resize  # reference bound (attack_resize.rs:63-66)

    comp = cat_image.copy()
    comp[160:385, 340:565] = marked[160:385, 340:565]
    ext2 = np.asarray(wm.extract(
        jnp.asarray(cat_image), jnp.asarray(comp), N, rcfg))
    sim_crop = float(np.asarray(
        wm.similarity(jnp.asarray(ext2), jnp.asarray(mark[None])))[0])
    # Oracle value on these pixels is 7.456 (test_oracle_parity.py).
    assert sim_crop > 7.3, sim_crop
