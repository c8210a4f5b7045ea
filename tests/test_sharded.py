"""Multi-device tests on the 8-way virtual CPU mesh.

These verify the determinism contract the reference never needed: identical
results for 1-chip vs N-chip execution (SURVEY.md section 5, "race tests
become determinism-across-shardings tests").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spread_spectrum_watermarking_tpu as wm
from spread_spectrum_watermarking_tpu.config import Ordering
from spread_spectrum_watermarking_tpu.ops import dct, ranking
from spread_spectrum_watermarking_tpu.parallel import (
    dct_sharded,
    make_mesh,
    pipeline_sharded,
)
from spread_spectrum_watermarking_tpu.parallel.mesh import SPATIAL_AXIS
from spread_spectrum_watermarking_tpu.parallel.topk_sharded import (
    distributed_top_indices,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def spatial_mesh():
    return make_mesh((1, 8))


@pytest.fixture(scope="module")
def data_mesh():
    return make_mesh((8, 1))


def test_sharded_dct_matches_single(spatial_mesh):
    rng = np.random.default_rng(0)
    y = rng.standard_normal((64, 96)).astype(np.float32)
    want = np.asarray(dct.dct2_2d(jnp.asarray(y)))
    got = np.asarray(dct_sharded.dct2_2d_sharded(jnp.asarray(y), spatial_mesh))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_sharded_idct_roundtrip(spatial_mesh):
    rng = np.random.default_rng(1)
    y = rng.standard_normal((64, 96)).astype(np.float32)
    c = dct_sharded.dct2_2d_sharded(jnp.asarray(y), spatial_mesh)
    back = np.asarray(dct_sharded.idct2_2d_sharded(c, spatial_mesh))
    np.testing.assert_allclose(back, y, atol=1e-4)


def test_sharded_dct_indivisible_matches_single(spatial_mesh):
    # Arbitrary sizes, like the reference (src/dct2d.rs:83-98): 63x97 is
    # divisible by neither 8 nor 2 -- pad-and-mask must be exact.
    rng = np.random.default_rng(4)
    y = rng.standard_normal((63, 97)).astype(np.float32)
    want = np.asarray(dct.dct2_2d(jnp.asarray(y)))
    got = np.asarray(dct_sharded.dct2_2d_sharded(jnp.asarray(y), spatial_mesh))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    back = np.asarray(dct_sharded.idct2_2d_sharded(
        jnp.asarray(got), spatial_mesh))
    np.testing.assert_allclose(back, y, atol=1e-4)


@pytest.mark.parametrize("ordering", list(Ordering))
def test_distributed_topk_matches_single(spatial_mesh, ordering):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(2)
    h, w = 32, 64
    coeffs = rng.standard_normal((h, w)).astype(np.float32)
    want = np.asarray(ranking.top_indices(jnp.asarray(coeffs), 50, ordering))

    got = shard_map(
        lambda blk: distributed_top_indices(blk, 50, ordering, h, w),
        mesh=spatial_mesh,
        in_specs=P(None, SPATIAL_AXIS),
        out_specs=P(None),
    )(jnp.asarray(coeffs))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_distributed_topk_tie_break(spatial_mesh):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    # Equal metrics across different shards: lower global index must win.
    h, w = 8, 64
    coeffs = np.zeros((h, w), dtype=np.float32)
    coeffs[0, 5] = 2.0    # shard 0
    coeffs[0, 60] = -2.0  # shard 7, equal energy, higher index
    coeffs[3, 10] = 2.0   # shard 1, equal energy, higher index
    got = np.asarray(shard_map(
        lambda blk: distributed_top_indices(blk, 3, Ordering.ENERGY, h, w),
        mesh=spatial_mesh,
        in_specs=P(None, SPATIAL_AXIS),
        out_specs=P(None),
    )(jnp.asarray(coeffs)))
    np.testing.assert_array_equal(got, [5, 60, 3 * 64 + 10])


def test_spatial_embed_matches_single_device(spatial_mesh, cat_image):
    # Crop the cat image to divisible dims; TP embed must equal the
    # single-device pipeline bit-for-bit after quantization.
    img = cat_image[:440, :640]
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(0), 500))
    want = np.asarray(wm.embed(jnp.asarray(img), jnp.asarray(mark)))
    got = np.asarray(pipeline_sharded.embed_spatial(
        jnp.asarray(img), jnp.asarray(mark), spatial_mesh))
    diff = np.abs(want.astype(int) - got.astype(int))
    # f32 reduction orders differ between the sharded and single-device DCT;
    # allow <=1 quantization step on a tiny fraction of pixels.
    assert (diff > 1).mean() == 0.0
    assert (diff > 0).mean() < 0.02, (diff > 0).mean()


def test_spatial_extract_roundtrip(spatial_mesh, cat_image):
    img = cat_image[:440, :640]
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(1), 500))
    marked = pipeline_sharded.embed_spatial(
        jnp.asarray(img), jnp.asarray(mark), spatial_mesh)
    ext = np.asarray(pipeline_sharded.extract_spatial(
        jnp.asarray(img), marked, 500, spatial_mesh))
    sim = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0]
    assert sim > 18.0, sim


def test_spatial_multimark(spatial_mesh, cat_image):
    img = cat_image[:440, :640]
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(2), 500, count=4))
    marked = pipeline_sharded.embed_spatial(
        jnp.asarray(img), jnp.asarray(marks), spatial_mesh)
    ext = np.asarray(pipeline_sharded.extract_spatial(
        jnp.asarray(img), marked, 500, spatial_mesh))
    sims = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(marks)))
    assert sims.min() > 5.0, sims


def test_batch_sharded_matches_single(data_mesh, cat_image):
    imgs = np.stack([cat_image] * 8)
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(3), 300, count=8))
    got = np.asarray(pipeline_sharded.embed_batch_sharded(
        jnp.asarray(imgs), jnp.asarray(marks[:, None, :]), data_mesh))
    want = np.asarray(wm.embed(jnp.asarray(imgs), jnp.asarray(marks[:, None, :])))
    np.testing.assert_array_equal(got, want)
    ext = np.asarray(pipeline_sharded.extract_batch_sharded(
        jnp.asarray(imgs), jnp.asarray(got), 300, data_mesh))
    sims = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(marks)))
    assert np.diagonal(sims).min() > 15.0


def test_spatial_embed_indivisible_uncropped_cat(spatial_mesh, cat_image):
    # The UNCROPPED 444x640 cat: 444 % 8 != 0. Pad-and-mask TP must agree
    # with the single-device pipeline.
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(4), 500))
    want = np.asarray(wm.embed(jnp.asarray(cat_image), jnp.asarray(mark)))
    got = np.asarray(pipeline_sharded.embed_spatial(
        jnp.asarray(cat_image), jnp.asarray(mark), spatial_mesh))
    assert got.shape == want.shape
    diff = np.abs(want.astype(int) - got.astype(int))
    assert (diff > 1).mean() == 0.0
    assert (diff > 0).mean() < 0.02, (diff > 0).mean()
    # And the TP read path detects it.
    ext = np.asarray(pipeline_sharded.extract_spatial(
        jnp.asarray(cat_image), jnp.asarray(got), 500, spatial_mesh))
    sim = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(mark[None])))[0]
    assert sim > 18.0, sim


def test_joint_data_spatial_mesh(cat_image):
    # A (data=2, spatial=4) mesh exercised on BOTH axes (round 1 tested
    # only (8,1)/(1,8) meshes).
    mesh = make_mesh((2, 4))
    img = cat_image  # 444x640: also indivisible by the spatial axis (4)
    mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(5), 400))
    got = np.asarray(pipeline_sharded.embed_spatial(
        jnp.asarray(img), jnp.asarray(mark), mesh))
    want = np.asarray(wm.embed(jnp.asarray(img), jnp.asarray(mark)))
    diff = np.abs(want.astype(int) - got.astype(int))
    assert (diff > 1).mean() == 0.0

    imgs = np.stack([img] * 2)
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(6), 400, count=2))
    dp = np.asarray(pipeline_sharded.embed_batch_sharded(
        jnp.asarray(imgs), jnp.asarray(marks[:, None, :]), mesh))
    dp_want = np.asarray(wm.embed(jnp.asarray(imgs), jnp.asarray(marks[:, None, :])))
    # On a joint mesh GSPMD may also partition the inner einsums over the
    # spatial axis, changing f32 reduction order -- allow <=1 quantization
    # step (the pure-DP (8,1) mesh is asserted bit-equal elsewhere).
    dp_diff = np.abs(dp_want.astype(int) - dp.astype(int))
    assert (dp_diff > 1).mean() == 0.0
    assert (dp_diff > 0).mean() < 0.02, (dp_diff > 0).mean()


def test_place_row_sharded_never_replicates(spatial_mesh, cat_image):
    # Non-divisible heights must still be genuinely row-sharded (round-2
    # ADVICE item 3): a replicated fallback would reinstate the per-device
    # memory ceiling for exactly the oversized single images TP exists for.
    placed = pipeline_sharded._place_row_sharded(cat_image, spatial_mesh)
    hp = placed.shape[0]
    assert hp % 8 == 0 and hp >= cat_image.shape[0]
    shard_rows = {s.data.shape[0] for s in placed.addressable_shards}
    assert shard_rows == {hp // 8}, shard_rows
    np.testing.assert_array_equal(
        np.asarray(placed)[: cat_image.shape[0]], cat_image)
    assert not np.any(np.asarray(placed)[cat_image.shape[0]:])


def test_corpus_dp_tp_roundtrip(cat_image):
    # BASELINE config 5's harness at CPU scale: a corpus sharded over a
    # joint (data=2, spatial=4) mesh -- DP over the batch, rows of every
    # image over the spatial axis, distributed top-k, and a local sparse
    # delta-IDCT write-back. Must agree with the single-device pipeline.
    mesh = make_mesh((2, 4))
    rng = np.random.default_rng(9)
    # 4 distinct crops of the cat (non-divisible height 441 exercises the
    # pad-and-mask path), one mark each.
    crops = np.stack([
        cat_image[oy:oy + 441, ox:ox + 512]
        for oy, ox in [(0, 0), (1, 64), (2, 128), (3, 16)]
    ])
    n = 400
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(7), n, count=4))

    marked_pad = np.asarray(pipeline_sharded.embed_corpus(
        jnp.asarray(crops), jnp.asarray(marks), mesh))
    assert marked_pad.shape[1] % 4 == 0
    marked = marked_pad[:, :441]
    assert not np.any(marked_pad[:, 441:])  # padding rows stay zero

    want = np.asarray(wm.embed(jnp.asarray(crops), jnp.asarray(marks[:, None, :])))
    diff = np.abs(want.astype(int) - marked.astype(int))
    assert (diff > 1).mean() == 0.0, diff.max()
    # The sharded transform sums in a different f32 order (row pass ->
    # all-to-all -> column pass, psum-gathered values), so a small fraction
    # of pixels sits on the other side of a quantization boundary.
    assert (diff > 0).mean() < 0.10

    # Extract through the DP x TP read path, from the padded embed output.
    ext = np.asarray(pipeline_sharded.extract_corpus(
        jnp.asarray(np.pad(crops, ((0, 0), (0, marked_pad.shape[1] - 441),
                                   (0, 0), (0, 0)))),
        jnp.asarray(marked_pad), n, mesh, height=441))
    assert ext.shape == (4, n)
    sims = np.asarray(wm.similarity(jnp.asarray(ext), jnp.asarray(marks)))
    # Each image detects its own mark strongly and not the others'.
    own = np.diag(sims)
    cross = sims[~np.eye(4, dtype=bool)]
    assert (own > 15.0).all(), own
    assert (np.abs(cross) < 4.0).all(), cross

    # And the single-device extraction agrees on the recovered values --
    # up to a handful of boundary rank swaps (the two transforms reduce in
    # different f32 orders, so the tail of the ranking can pick different
    # near-equal-energy coefficients).
    ext_single = np.asarray(wm.extract(
        jnp.asarray(crops), jnp.asarray(marked), n))
    agree = np.abs(ext - ext_single) < 5e-2
    assert agree.mean() > 0.99, agree.mean()


def test_staged_pipeline_matches_fast_path():
    # Pipeline-parallel (GPipe-style) embed: the staged schedule must be a
    # pure execution-order change -- bit-identical u8 output to the fast-path
    # pipeline per microbatch (SURVEY.md section 2.1 PP row).
    from spread_spectrum_watermarking_tpu.config import Precision, WriteConfig
    from spread_spectrum_watermarking_tpu.models import pipeline
    from spread_spectrum_watermarking_tpu.parallel import pipeline_staged as ps

    rng = np.random.default_rng(7)
    m, b, h, w = 4, 2, 96, 128
    imgs = rng.integers(0, 256, (m, b, h, w, 3), dtype=np.uint8)
    marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(1), 50))
    mesh = ps.make_stage_mesh()
    for prec in (Precision.DEFAULT, Precision.HIGH):
        cfg = WriteConfig(precision=prec)
        out = np.asarray(ps.embed_staged(
            jnp.asarray(imgs), jnp.asarray(marks), mesh, cfg))
        ref = np.stack([
            np.asarray(pipeline.embed(jnp.asarray(imgs[i]),
                                      jnp.asarray(marks[None]), cfg))
            for i in range(m)])
        assert np.array_equal(out, ref), prec
    # Multi-mark staging follows the same delta-additive semantics.
    marks4 = np.asarray(wm.generate_normal(jax.random.PRNGKey(2), 50, count=4))
    cfg = WriteConfig(precision=Precision.DEFAULT)
    out = np.asarray(ps.embed_staged(
        jnp.asarray(imgs), jnp.asarray(marks4), mesh, cfg))
    ref = np.stack([
        np.asarray(pipeline.embed(jnp.asarray(imgs[i]), jnp.asarray(marks4),
                                  cfg))
        for i in range(m)])
    assert np.array_equal(out, ref)
    # HIGHEST is the reference-exact parity tier; it is not staged.
    with pytest.raises(ValueError, match="fast-tier"):
        ps.embed_staged(jnp.asarray(imgs), jnp.asarray(marks), mesh,
                        WriteConfig(precision=Precision.HIGHEST))
