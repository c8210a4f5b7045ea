"""Decoder-invariant quality gate: our pipeline vs a float64 scipy oracle.

The reference's attack-suite numbers (crop 8.07 sigma, max extraction error
< 0.12, tests/attack_crop.rs:91-94 / single_simple.rs:59-70) are statistics
of the exact u8 pixels its Rust ``jpeg-decoder`` produced from the base JPEG.
Those pixels are not recoverable here (libjpeg decodes the file slightly
differently), so the question is: is the remaining gap decoder skew or a real
pipeline deficit?

This module settles it with two measurements:

1. **An independent oracle** (:mod:`spread_spectrum_watermarking_tpu.oracle`):
   the reference algorithm re-implemented from its spec in float64 numpy +
   scipy.fftpack, sharing no code with the pipeline. On IDENTICAL pixels the
   oracle and our pipeline agree to
   ~1e-3 on every statistic -- measured (PIL-decoded cat, seed-1/seed-2
   fixture marks):

       statistic            oracle    ours
       seed-1 max err       0.1485    0.1477
       seed-1 mean err      0.0194    0.0194
       seed-1 self-sim      31.886    31.886
       seed-2 crop sim       7.456     7.456
       seed-2 resize sim    10.050    10.050

   So on libjpeg's pixels the *reference algorithm itself* lands at
   max-err 0.1485 (> its 0.12 bound) and crop 7.456 (< its 8.0 bound): the
   deltas vs the published numbers are entirely the decoder's pixels.

2. **A sensitivity bound.** Flipping a random ~10% of samples by +-1 (the
   scale of JPEG-decoder disagreement) swings seed-1 max err across
   [0.108, 0.177] and seed-2 crop sim across [7.37, 9.72] -- both straddle
   the reference's thresholds, confirming those exact numbers are not
   decoder-invariant statistics. The robust statistics (mean err < 0.02,
   self-sim > 31.2, resize > 9.5) hold on every decode and are asserted at
   the reference's own bounds in test_parity.py / test_attacks.py.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
fftpack = pytest.importorskip("scipy.fftpack")

import spread_spectrum_watermarking_tpu as wm
from spread_spectrum_watermarking_tpu.oracle import embed as _oracle_embed
from spread_spectrum_watermarking_tpu.oracle import extract as _oracle_extract
from spread_spectrum_watermarking_tpu.oracle import sim as _sim
from spread_spectrum_watermarking_tpu.utils import rng_compat

N = 1000


def _our_extract_sim(base, derived, mark):
    ext = np.asarray(wm.extract(jnp.asarray(base), jnp.asarray(derived), N))
    return ext, float(np.asarray(
        wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None].astype(np.float32))))[0])


@pytest.fixture(scope="module")
def seed1(cat_image):
    mark = rng_compat.generate_fixed_normal_sequence(1, N).astype(np.float64)
    o_marked, o_order = _oracle_embed(cat_image, mark)
    ours = np.asarray(wm.embed(jnp.asarray(cat_image),
                               jnp.asarray(mark.astype(np.float32))))
    return cat_image, mark, o_marked, o_order, ours


def test_oracle_and_pipeline_outputs_nearly_identical(seed1):
    # The two watermarked u8 images may differ only by off-by-one rounding at
    # a tiny fraction of pixels (f32 vs f64 arithmetic at the round boundary).
    _, _, o_marked, _, ours = seed1
    diff = o_marked.astype(int) - ours.astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.005, (diff != 0).mean()


def test_quantization_error_matches_oracle(seed1):
    cat, mark, o_marked, o_order, ours = seed1
    o_ext = _oracle_extract(cat, o_marked, o_order)
    o_err = np.abs(o_ext - mark)
    ext, sim = _our_extract_sim(cat, ours, mark)
    err = np.abs(ext - mark.astype(np.float32))
    # Our max/mean error must be at or below the float64 oracle's (+epsilon):
    # the correct-implementation bound on THESE pixels, where the oracle
    # itself measures 0.1485 max -- above the reference's in-decoder 0.12.
    assert err.max() <= o_err.max() + 0.01, (err.max(), o_err.max())
    assert abs(err.mean() - o_err.mean()) < 0.002, (err.mean(), o_err.mean())
    assert abs(sim - _sim(o_ext, mark)) < 0.2, (sim, _sim(o_ext, mark))


def test_crop_attack_matches_oracle(cat_image):
    mark = rng_compat.generate_fixed_normal_sequence(2, N).astype(np.float64)
    o_marked, o_order = _oracle_embed(cat_image, mark)
    ours = np.asarray(wm.embed(jnp.asarray(cat_image),
                               jnp.asarray(mark.astype(np.float32))))
    # 225x225 crop at (340,160) composited over the original
    # (reference: tests/attack_crop.rs:36-70).
    o_comp = cat_image.copy()
    o_comp[160:385, 340:565] = o_marked[160:385, 340:565]
    comp = cat_image.copy()
    comp[160:385, 340:565] = ours[160:385, 340:565]
    o_sim = _sim(_oracle_extract(cat_image, o_comp, o_order), mark)
    _, sim = _our_extract_sim(cat_image, comp, mark)
    # Measured: oracle 7.456, ours 7.456 on libjpeg pixels (reference
    # measured 8.07 on its own decoder's pixels).
    assert abs(sim - o_sim) < 0.1, (sim, o_sim)


def test_resize_attack_matches_oracle_and_reference_bound(cat_image):
    from PIL import Image

    mark = rng_compat.generate_fixed_normal_sequence(2, N).astype(np.float64)
    o_marked, o_order = _oracle_embed(cat_image, mark)
    ours = np.asarray(wm.embed(jnp.asarray(cat_image),
                               jnp.asarray(mark.astype(np.float32))))
    h, w = cat_image.shape[:2]

    def attack(img):
        im = Image.fromarray(img)
        small = im.resize((w // 8, h // 8), Image.BICUBIC)
        return np.asarray(small.resize((w, h), Image.BICUBIC))

    o_sim = _sim(_oracle_extract(cat_image, attack(o_marked), o_order), mark)
    _, sim = _our_extract_sim(cat_image, attack(ours), mark)
    assert abs(sim - o_sim) < 0.1, (sim, o_sim)
    # The reference's own resize bound holds here (measured 10.05 > 9.5,
    # reference asserts > 9.5 at tests/attack_resize.rs:63-66).
    assert sim > 9.5, sim


def _psnr(a_u8, b_u8):
    mse = np.mean((a_u8.astype(np.float64) - b_u8.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def test_psnr_at_or_above_reference(seed1):
    # BASELINE north star: "decoded watermarked output must match ... PSNR >=
    # reference". The reference's output is the float64 oracle's (same
    # algorithm, exact arithmetic; the reference's own f32 output can only be
    # noisier). Measured on the cat image, seed-1 mark: oracle 36.45 dB;
    # ours 36.45 dB at HIGHEST (this assert). The fast tiers measured
    # 36.38-36.41 dB on the CPU backend, within 0.08 dB of the reference
    # (bf16-estimate noise). Gate: exact tier at the reference, fast tiers
    # within 0.15 dB of it.
    cat, mark, o_marked, _, ours = seed1
    ref_psnr = _psnr(o_marked, cat)
    assert _psnr(ours, cat) >= ref_psnr - 0.01, (_psnr(ours, cat), ref_psnr)
    m32 = jnp.asarray(mark.astype(np.float32))
    for prec in (wm.Precision.HIGH, wm.Precision.DEFAULT):
        fast = np.asarray(wm.embed(jnp.asarray(cat), m32,
                                   wm.WriteConfig(precision=prec)))
        p = _psnr(fast, cat)
        assert p >= ref_psnr - 0.15, (prec, p, ref_psnr)
    # Corpus-scale spot check: PSNR holds on a batch of natural crops, not
    # just the single fixture (mosaic crops like the bench corpus).
    hc, wc = 128, 160
    crops = np.stack([cat[16 * i:16 * i + hc, 24 * i:24 * i + wc]
                      for i in range(4)])
    cmarks = np.asarray(wm.generate_normal(
        __import__("jax").random.PRNGKey(9), 500, count=4))
    marked = np.asarray(wm.embed(jnp.asarray(crops),
                                 jnp.asarray(cmarks[:, None, :])))
    for i in range(4):
        o_m, _ = _oracle_embed(crops[i], cmarks[i].astype(np.float64), 500)
        assert _psnr(marked[i], crops[i]) >= _psnr(o_m, crops[i]) - 0.05
