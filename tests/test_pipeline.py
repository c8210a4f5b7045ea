"""Integration tests on the reference's cat image (cf. tests/single_simple.rs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spread_spectrum_watermarking_tpu as wm


N = 1000


@pytest.fixture(scope="module")
def embedded(cat_image):
    key = jax.random.PRNGKey(1)
    mark = np.asarray(wm.generate_normal(key, N))
    marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark)))
    return cat_image, mark, marked


def test_embed_extract_self_similarity(embedded):
    # Mirrors tests/single_simple.rs: embed, quantize to u8, extract, and
    # check per-coefficient error (<0.12 max, <0.02 mean after quantization,
    # single_simple.rs:59-70) and self-similarity (~31 sigma, :78-79).
    cat, mark, marked = embedded
    ext = np.asarray(wm.extract(jnp.asarray(cat), jnp.asarray(marked), N))
    err = np.abs(ext - mark)
    assert err.max() < 0.12, err.max()
    assert err.mean() < 0.02, err.mean()
    sim = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0]
    assert sim > 25.0, sim  # reference: 31.24 with its own RNG sequence
    # Null hypothesis: a random mark stays under 3 sigma
    # (single_simple.rs:84-90 uses < 2 for one fixed seed).
    rand = np.asarray(wm.generate_normal(jax.random.PRNGKey(0xBAAAAAAD), N))
    rand_sim = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(rand[None])))[0]
    assert abs(rand_sim) < 3.0, rand_sim


def test_unquantized_extraction_near_exact(cat_image):
    # Without u8 quantization the round trip recovers the mark to float
    # precision -- validates DCT inverse + modulation inverse jointly.
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(5), N))
    marked = np.asarray(
        wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), quantize=False))
    ext = np.asarray(wm.extract(jnp.asarray(cat_image), jnp.asarray(marked), N))
    # Residual error stems from the YIQ->RGB [0,1] clamp (present in the
    # reference too, src/yiq.rs:174) and f32 transform precision; it must be
    # well under the quantized pipeline's 0.02 bound.
    err = np.abs(ext - mark)
    assert err.mean() < 0.01, err.mean()


ALL_PRECISIONS = [wm.Precision.HIGHEST, wm.Precision.HIGH,
                  wm.Precision.DEFAULT]


@pytest.mark.parametrize("precision", ALL_PRECISIONS)
def test_batch_matches_single(cat_image, precision):
    # Batched embed over B=3 must equal three single embeds, at every
    # precision tier (the fast tiers take _embed_fast, a separate code path).
    wcfg = wm.WriteConfig(precision=precision)
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(2), N, count=3))
    batch = np.stack([cat_image] * 3)
    out_b = np.asarray(
        wm.embed(jnp.asarray(batch), jnp.asarray(marks[:, None, :]), wcfg))
    for i in range(3):
        out_i = np.asarray(
            wm.embed(jnp.asarray(cat_image), jnp.asarray(marks[i]), wcfg))
        # Matmul tiling differs with batch size (and with the epilogue
        # consumer's layout), so the delta-IDCT's bf16/f32 reduction order
        # differs between the two compiled programs and can flip values
        # sitting at a u8 rounding boundary; allow <=1 step on a small
        # fraction of pixels (measured ~0.3% at the fast tiers with the
        # channel-planar epilogue). Detection-quality invariance across
        # tiers is pinned separately by tests/test_precision_gate.py.
        diff = np.abs(out_b[i].astype(int) - out_i.astype(int))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() < 1e-2, (diff > 0).mean()


@pytest.mark.parametrize("precision", ALL_PRECISIONS)
def test_multimark_interference(cat_image, precision):
    # 16 marks into one image (BASELINE.json config 2): every mark must
    # still be detectable, and all sims are computed in one sweep. Runs at
    # every precision tier -- the fast tiers previously embedded only mark 0
    # from a shared (M, N) mark set.
    m = 16
    wcfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(3), N, count=m))
    marked = np.asarray(
        wm.embed(jnp.asarray(cat_image), jnp.asarray(marks), wcfg))
    ext = np.asarray(
        wm.extract(jnp.asarray(cat_image), jnp.asarray(marked), N, rcfg))
    sims = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(marks)))
    assert sims.shape == (m,)
    # With 16 interfering marks the expected per-mark sim drops to roughly
    # 31/sqrt(16) ~ 7.8 with sampling spread; all must stay far above null.
    assert sims.min() > 4.0, sims
    # Random marks remain null.
    rand = np.asarray(wm.generate_normal(jax.random.PRNGKey(4), N, count=8))
    null = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(rand)))
    assert np.abs(null).max() < 4.0, null


@pytest.mark.parametrize("precision",
                         [wm.Precision.HIGH, wm.Precision.DEFAULT])
def test_batched_shared_multimark_matches_highest(cat_image, precision):
    # Regression: a batch of 2 images x 4 SHARED (M, N) marks at a
    # fast precision crashed with a broadcast TypeError, and a single image
    # silently embedded only mark 0. Both must now match the HIGHEST path.
    m = 4
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(11), N, count=m))
    batch = np.stack([cat_image, cat_image[:, ::-1]])  # two distinct images

    def sims_at(precision):
        wcfg = wm.WriteConfig(precision=precision)
        rcfg = wm.ReadConfig(precision=precision)
        marked = np.asarray(
            wm.embed(jnp.asarray(batch), jnp.asarray(marks), wcfg))
        ext = np.asarray(
            wm.extract(jnp.asarray(batch), jnp.asarray(marked), N, rcfg))
        return np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(marks)))

    got = sims_at(precision)
    ref = sims_at(wm.Precision.HIGHEST)
    assert got.shape == (2, m)
    np.testing.assert_allclose(got, ref, atol=1.0)
    assert got.min() > 4.0, got


@pytest.mark.parametrize("precision", [wm.Precision.HIGHEST, wm.Precision.HIGH,
                                       wm.Precision.DEFAULT])
def test_writer_reader_tester_wrappers(cat_image, precision):
    # The wrapper (prepared-base) read path must stay reference-grade at
    # every tier: at the fast tiers it caches (indices, base values) from
    # the Writer's own prologue and transforms the luma *difference*
    # (pipeline.rank_base/extract_ranked) -- two independently bf16-rounded
    # coefficient planes would bury the watermark in rounding noise
    # (regression: round-3 Reader-at-DEFAULT bug, 5.6 sigma vs 30.8).
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(6), N))
    wcfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    marked = wm.Writer(cat_image, wcfg).mark(mark)
    assert marked.dtype == np.uint8 and marked.shape == cat_image.shape
    reader = wm.Reader.base(cat_image, rcfg)
    ext = reader.extract(wm.Reader.derived(marked), N)
    sim = wm.Tester(ext).similarity(mark)
    assert sim.exceeds_sigma(25.0)
    other = np.asarray(wm.generate_normal(jax.random.PRNGKey(7), N))
    assert not wm.Tester(ext).similarity(other).exceeds_sigma(3.0)
    # The cached base work must serve a second derived image (the reference
    # CLI's extraction cache, examples/main.rs:369-412).
    marked2 = wm.Writer(cat_image, wcfg).mark(other)
    ext2 = reader.extract(wm.Reader.derived(marked2), N)
    assert wm.Tester(ext2).similarity(other).exceeds_sigma(25.0)
    # The wrapper must agree with the functional read path: bit-for-bit at
    # the fast tiers (same prologue, same tail); at HIGHEST the prepared
    # full-plane form differs from the fused sparse derived transform only
    # by f32 reassociation.
    direct = np.asarray(wm.extract(jnp.asarray(cat_image), jnp.asarray(marked),
                                   N, rcfg))
    atol = 1e-3 if precision is wm.Precision.HIGHEST else 1e-5
    np.testing.assert_allclose(ext, direct, atol=atol)


def test_option1_and_option3_end_to_end(cat_image):
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(8), N))
    for method, alpha in [(wm.Method.OPTION1, 50.0), (wm.Method.OPTION3, 0.1)]:
        # Option1's alpha is absolute (reference main.rs:64-66) -- DCT
        # coefficients of a 640x444 image are large, so use a large alpha.
        wcfg = wm.WriteConfig(insertion=wm.InsertExtract(alpha=alpha, method=method))
        rcfg = wm.ReadConfig(extraction=wm.InsertExtract(alpha=alpha, method=method))
        marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), wcfg))
        ext = np.asarray(
            wm.extract(jnp.asarray(cat_image), jnp.asarray(marked), N, rcfg))
        sim = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0]
        assert sim > 10.0, (method, sim)


def test_orderings_end_to_end(cat_image):
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(9), N))
    for ordering in [wm.Ordering.ENERGY_ORTHOGONAL, wm.Ordering.LEGACY]:
        wcfg = wm.WriteConfig(ordering=ordering)
        rcfg = wm.ReadConfig(ordering=ordering)
        marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), wcfg))
        ext = np.asarray(
            wm.extract(jnp.asarray(cat_image), jnp.asarray(marked), N, rcfg))
        sim = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0]
        assert sim > 10.0, (ordering, sim)


def test_custom_insert_extract(cat_image):
    # The reference's Insertion::Custom/Extraction::Custom closures
    # (src/algorithm.rs:76,123) -> traced callables here.
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(10), N))
    ins = lambda idx, orig, w: orig * (1.0 + 0.2 * w)
    ext_fn = lambda idx, base, derived: (derived - base) / (base * 0.2)
    wcfg = wm.WriteConfig(custom_insert=ins)
    rcfg = wm.ReadConfig(custom_extract=ext_fn)
    marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), wcfg))
    ext = np.asarray(wm.extract(jnp.asarray(cat_image), jnp.asarray(marked), N, rcfg))
    sim = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0]
    assert sim > 25.0, sim


def test_sparse_derived_matches_full_read_path(embedded):
    # The default read path computes derived coefficients sparsely (one DCT
    # pass + gather-dot); it must agree with the reference-style full second
    # transform to f32 reassociation tolerance.
    cat, mark, marked = embedded
    fast = np.asarray(wm.extract(jnp.asarray(cat), jnp.asarray(marked), N))
    full = np.asarray(wm.extract(jnp.asarray(cat), jnp.asarray(marked), N,
                                 sparse_derived=False))
    np.testing.assert_allclose(fast, full, atol=1e-4)
    # At the fast tiers the flag selects gather-dot vs full second pass of
    # the *delta* plane; both are delta-exact and must agree to bf16-dot
    # reassociation tolerance on the extracted mark (unit-scale values).
    # Same-tier roundtrip (write and read share the tier -- the production
    # contract; cross-tier rank order differs, see approx_top_indices).
    wcfg = wm.WriteConfig(precision=wm.Precision.DEFAULT)
    rcfg = wm.ReadConfig(precision=wm.Precision.DEFAULT)
    marked_d = np.asarray(wm.embed(jnp.asarray(cat), jnp.asarray(mark), wcfg))
    fast_d = np.asarray(wm.extract(jnp.asarray(cat), jnp.asarray(marked_d), N, rcfg))
    full_d = np.asarray(wm.extract(jnp.asarray(cat), jnp.asarray(marked_d), N, rcfg,
                                   sparse_derived=False))
    np.testing.assert_allclose(fast_d, full_d, atol=2e-2)
    sim = np.asarray(wm.similarity(jnp.asarray(full_d), jnp.asarray(mark[None])))[0]
    assert sim > 25.0, sim


def test_error_conditions(cat_image):
    with pytest.raises(ValueError, match="not equal"):
        wm.extract(jnp.asarray(cat_image), jnp.asarray(cat_image[:100]), 10)
    h, w = cat_image.shape[:2]
    with pytest.raises(ValueError, match="exceeds available"):
        wm.extract(jnp.asarray(cat_image), jnp.asarray(cat_image), h * w)


@pytest.mark.parametrize("precision", [wm.Precision.HIGHEST, wm.Precision.HIGH,
                                       wm.Precision.DEFAULT])
def test_embed_verified_matches_separate_calls(cat_image, precision):
    # The fused embed+verify program (the reference CLI's -p round trip,
    # examples/main.rs:306-316, sharing the base prologue) must produce the
    # same marked image as embed() and an extraction equivalent to
    # extract() on it.
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(21), N))
    wcfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    marked_v, ext_v = wm.embed_verified(jnp.asarray(cat_image),
                                        jnp.asarray(mark), wcfg)
    marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), wcfg))
    assert np.array_equal(np.asarray(marked_v), marked)
    ext = np.asarray(wm.extract(jnp.asarray(cat_image), jnp.asarray(marked),
                                N, rcfg))
    atol = 2e-3 if precision is wm.Precision.HIGHEST else 1e-5
    np.testing.assert_allclose(np.asarray(ext_v), ext, atol=atol)
    sim = float(np.asarray(wm.similarity(
        jnp.asarray(np.asarray(ext_v)[None]), jnp.asarray(mark[None])))[0, 0])
    assert sim > 25.0, sim
    with pytest.raises(ValueError, match="custom_insert"):
        wm.embed_verified(jnp.asarray(cat_image), jnp.asarray(mark),
                          wm.WriteConfig(custom_insert=lambda i, o, w: o))


@pytest.mark.parametrize("precision", ALL_PRECISIONS)
@pytest.mark.parametrize("sparse_idct", [True, False])
def test_sparse_idct_flag_detectable_at_every_tier(cat_image, precision,
                                                   sparse_idct):
    # Regression: embed(sparse_idct=False) at a fast
    # tier used to rank through the exact HIGHEST-style prologue while the
    # fast Reader ranks on the bf16 plane, embedding marks the Reader could
    # not detect (2.29 sigma vs 31.88 at DEFAULT on this very image). The
    # Writer must rank identically to the Reader at every tier regardless of
    # the inverse-transform shape (reference: src/algorithm.rs:462-498, the
    # reader re-derives the writer's ordering).
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(31), N))
    wcfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark),
                                 wcfg, sparse_idct=sparse_idct))
    ext = np.asarray(wm.extract(jnp.asarray(cat_image), jnp.asarray(marked),
                                N, rcfg))
    sim = float(np.asarray(wm.similarity(jnp.asarray(ext),
                                         jnp.asarray(mark[None])))[0])
    assert sim > 25.0, (precision, sparse_idct, sim)


@pytest.mark.parametrize("precision", ALL_PRECISIONS)
def test_writer_reader_inspection_matches_active_tier(cat_image, precision):
    # Writer.indices()/coefficients() must describe what
    # mark() actually embeds at the ACTIVE tier (reference accessors describe
    # the object's real state, src/algorithm.rs:319-327,502-508). At DEFAULT
    # the old HIGHEST-style accessor overlapped the embedded indices only
    # 789/1000.
    from spread_spectrum_watermarking_tpu.models import pipeline

    wcfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    writer = wm.Writer(cat_image, wcfg)
    idx_w = writer.indices(N)
    if precision is wm.Precision.HIGHEST:
        idx_p = np.asarray(pipeline.prepare_base(
            jnp.asarray(cat_image), N, rcfg)[1])
    else:
        idx_p = np.asarray(pipeline.rank_base(
            jnp.asarray(cat_image), N, rcfg)[0])
    np.testing.assert_array_equal(idx_w, idx_p)
    # Reader agrees with Writer (the invariant the reference builds on).
    reader = wm.Reader.base(cat_image, rcfg)
    np.testing.assert_array_equal(reader.indices(N), idx_w)
    # coefficients() returns the plane the tier ranks on: its metric at the
    # returned indices must be (weakly) descending -- i.e. the indices ARE
    # this plane's top-n, not some other tier's.
    plane = writer.coefficients()
    metric = np.asarray(plane, dtype=np.float32).reshape(-1) ** 2
    m = metric[idx_w]
    if precision is not wm.Precision.HIGHEST:
        # The rank keys are the plane's bf16 rounding; compare in bf16 grid.
        m = m.astype(np.float32)
        assert (m[:-1] >= m[1:] * (1 - 2e-2)).all()
    else:
        assert (m[:-1] >= m[1:]).all()


def test_rank_version_1_roundtrip_and_divergence(cat_image):
    # The legacy (value-gather) fast ranking stays available behind
    # rank_version=1 for marks stored under the "Default"/"High" spellings
    # (ADVICE r3 item 1). It must still detect at reference grade, and must
    # genuinely differ from generation 2 (otherwise the spelling split is
    # pointless).
    from spread_spectrum_watermarking_tpu.models import pipeline

    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(37), N))
    wcfg = wm.WriteConfig(precision=wm.Precision.DEFAULT, rank_version=1)
    rcfg = wm.ReadConfig(precision=wm.Precision.DEFAULT, rank_version=1)
    marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), wcfg))
    ext = np.asarray(wm.extract(jnp.asarray(cat_image), jnp.asarray(marked),
                                N, rcfg))
    sim = float(np.asarray(wm.similarity(jnp.asarray(ext),
                                         jnp.asarray(mark[None])))[0])
    assert sim > 25.0, sim
    i1 = np.asarray(pipeline.rank_base(jnp.asarray(cat_image), N, rcfg)[0])
    i2 = np.asarray(pipeline.rank_base(
        jnp.asarray(cat_image), N,
        wm.ReadConfig(precision=wm.Precision.DEFAULT, rank_version=2))[0])
    # Same plane, different selection/ordering generation: high overlap as
    # sets, materially different rank order (measured 996/1000 overlap,
    # 324/1000 positional agreement on this image).
    assert not np.array_equal(i1, i2)
    assert len(set(i1.tolist()) & set(i2.tolist())) > 0.97 * N


@pytest.mark.parametrize("precision",
                         [wm.Precision.HIGHEST, wm.Precision.DEFAULT])
def test_writer_update_indices(cat_image, precision):
    # Reference Writer::update_indices (src/algorithm.rs:324-327): swap the
    # ordering on an existing Writer; ranking and marking then follow the
    # new ordering exactly as a fresh Writer's would.
    w1 = wm.Writer(cat_image, wm.WriteConfig(precision=precision))
    idx_energy = w1.indices(200)
    w1.update_indices(wm.Ordering.LEGACY)
    idx_legacy = w1.indices(200)
    fresh = wm.Writer(cat_image, wm.WriteConfig(
        precision=precision, ordering=wm.Ordering.LEGACY))
    np.testing.assert_array_equal(idx_legacy, fresh.indices(200))
    assert not np.array_equal(idx_energy, idx_legacy)


@pytest.mark.parametrize("geometry", ["portrait", "odd-landscape",
                                      "odd-portrait"])
@pytest.mark.parametrize("precision", ALL_PRECISIONS)
def test_geometry_coverage(cat_image, geometry, precision):
    # The fast prologue contracts the SHORTER image axis (_shorter_axis), so
    # portrait images take the axis=-1 branches of _half_pass/_second_pass/
    # dct2_dot_at that landscape fixtures never touch, and odd dimensions
    # exercise non-tile-aligned shapes (the reference handles any W x H,
    # src/dct2d.rs:83-98). Measured 29.9 sigma for every (geometry, tier).
    if geometry == "portrait":
        img = np.swapaxes(cat_image, 0, 1).copy()
    elif geometry == "odd-landscape":
        img = cat_image[:443, :639].copy()
    else:
        img = np.swapaxes(cat_image, 0, 1)[:639, :443].copy()
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(3), 800))
    wcfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    marked = np.asarray(wm.embed(jnp.asarray(img), jnp.asarray(mark), wcfg))
    ext = np.asarray(wm.extract(jnp.asarray(img), jnp.asarray(marked),
                                800, rcfg))
    sim = float(ext @ mark / np.sqrt(ext @ ext))
    assert sim > 25.0, (geometry, precision, sim)


@pytest.mark.parametrize("precision",
                         [wm.Precision.HIGHEST, wm.Precision.DEFAULT])
def test_partial_length_extraction(cat_image, precision):
    # The reference permits extracting FEWER coefficients than were embedded
    # (extract_watermark only checks extracted.len() < base count,
    # src/algorithm.rs:550-561): the first m ranks pair with mark[:m]
    # because write and read derive the same rank order. Expected sim scales
    # like sqrt(m/n) of the full-length statistic (~31 -> ~22 at m=n/2).
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(41), N))
    wcfg = wm.WriteConfig(precision=precision)
    rcfg = wm.ReadConfig(precision=precision)
    marked = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark), wcfg))
    for m in (500, 100):
        ext = np.asarray(wm.extract(jnp.asarray(cat_image),
                                    jnp.asarray(marked), m, rcfg))
        sim = float(ext @ mark[:m] / np.sqrt(ext @ ext))
        # sqrt(m/N) scaling with generous slack for the short-sum variance.
        assert sim > 0.6 * 31.0 * (m / N) ** 0.5, (m, sim)


def test_readme_quickstart_flow():
    # The README's Quick start snippet, at test scale: the four-line batched
    # API (generate_normal -> embed -> extract -> similarity sweep) must
    # work exactly as documented, with per-image marks and a (B, B) sweep.
    rng = np.random.default_rng(7)
    images = jnp.asarray(rng.integers(0, 256, (3, 64, 96, 3), dtype=np.uint8))
    marks = wm.generate_normal(jax.random.PRNGKey(0), 200,
                               count=images.shape[0])
    marked = wm.embed(images, marks[:, None, :])
    extracted = wm.extract(images, marked, 200)
    sims = np.asarray(wm.similarity(extracted, marks))
    assert sims.shape == (3, 3)
    assert np.diagonal(sims).min() > 6.0
    off = sims[~np.eye(3, dtype=bool)]
    assert np.abs(off).max() < 3.0
