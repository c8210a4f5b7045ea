"""Sharded end-to-end pipelines: DP over image batches, TP over one huge image.

Two scaling modes (SURVEY.md section 2.1):

- :func:`embed_batch_sharded` / :func:`extract_batch_sharded`: data-parallel
  -- shard the batch axis over the mesh's ``data`` axis. The per-image
  program is untouched; XLA partitions the batched einsums and top-k.

- :func:`embed_spatial` / :func:`extract_spatial`: tensor/spatial-parallel
  for a single image too large for one chip -- the sharded DCT's all-to-all
  (dct_sharded.py) plus the distributed top-k (topk_sharded.py), with
  modulation running replicated on the gathered top-n values and scattered
  back into the column-sharded coefficient layout.

- :func:`embed_corpus` / :func:`extract_corpus`: joint DP x TP for a corpus
  of images each too large for one device (BASELINE config 5: a 4K corpus
  sharded across devices). One shard_map over BOTH mesh axes: the
  batch is split over ``data``, each image's rows over ``spatial``. The
  forward transform is the sharded DCT (one all-to-all per image over the
  spatial axis only);
  the inverse is a purely LOCAL sparse delta-IDCT: after the distributed
  top-k replicates the (n,) modulated deltas over the spatial axis, each
  device reconstructs dY for its own row block with one skinny matmul, so
  the write-back needs no collective at all and only luma is ever touched
  (RGB' = clamp(RGB + dY), the Y column of YIQ->RGB being [1,1,1]).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import ReadConfig, WriteConfig, jax_precision
from ..models import pipeline
from ..ops import colorspace, modulation
from .dct_sharded import (_pad_last2, dct2_2d_sharded_padded,
                          idct2_2d_sharded_padded, padded_size,
                          replicated_basis)
from .mesh import DATA_AXIS, SPATIAL_AXIS
from .topk_sharded import distributed_top_indices


# ---------------------------------------------------------------------------
# Data-parallel batch pipelines
# ---------------------------------------------------------------------------


def embed_batch_sharded(rgb, marks, mesh: Mesh,
                        config: WriteConfig = WriteConfig(), quantize=True):
    """DP embed: (B, H, W, 3) images sharded over the data axis."""
    bs = NamedSharding(mesh, P(DATA_AXIS))
    rgb = jax.device_put(rgb, NamedSharding(mesh, P(DATA_AXIS, None, None, None)))
    marks = jax.device_put(marks, bs)
    return pipeline.embed(rgb, marks, config, quantize=quantize)


def extract_batch_sharded(base, derived, n: int, mesh: Mesh,
                          config: ReadConfig = ReadConfig()):
    """DP extract: both image batches sharded over the data axis."""
    sh = NamedSharding(mesh, P(DATA_AXIS, None, None, None))
    base = jax.device_put(base, sh)
    derived = jax.device_put(derived, sh)
    return pipeline.extract(base, derived, n, config)


# ---------------------------------------------------------------------------
# Spatial (tensor-parallel) single-image pipelines
# ---------------------------------------------------------------------------


def _modulate_sharded(coeffs, marks, mesh: Mesh, config: WriteConfig,
                      height: int, width: int):
    """Top-k + modulation + scatter on P(None, spatial) coefficients."""

    def local(coef_blk, marks_rep):
        h, wb = coef_blk.shape
        my_id = jax.lax.axis_index(SPATIAL_AXIS)
        n = marks_rep.shape[-1]

        idx = distributed_top_indices(coef_blk, n, config.ordering,
                                      height, width)  # replicated (n,)
        rows = idx // width
        cols = idx % width
        owner = cols // wb
        local_flat = rows * wb + (cols - my_id * wb)

        flat_blk = coef_blk.reshape(-1)
        mine = owner == my_id
        # Gather owned values, zero elsewhere, then psum -> replicated values.
        safe_gather = jnp.where(mine, local_flat, 0)
        vals = jnp.where(mine, flat_blk[safe_gather], 0.0)
        original = jax.lax.psum(vals, SPATIAL_AXIS)  # replicated (n,)

        new_values = modulation.embed_marks(
            original, marks_rep, config.insertion.method,
            config.insertion.alpha, custom_insert=config.custom_insert,
            indices=idx)

        # Scatter owned updates; non-owned positions aimed out of bounds.
        oob = jnp.asarray(flat_blk.shape[0], dtype=local_flat.dtype)
        scatter_idx = jnp.where(mine, local_flat, oob)
        flat_blk = flat_blk.at[scatter_idx].set(new_values, mode="drop")
        return flat_blk.reshape(h, wb)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(None, SPATIAL_AXIS), P(None)),
        out_specs=P(None, SPATIAL_AXIS),
    )(coeffs, marks)


def _spatial_bases(mesh: Mesh, h: int, w: int, kinds):
    """Replicated (Hp, Hp) and (Wp, Wp) bases of each kind, in order."""
    ns = mesh.shape[SPATIAL_AXIS]
    return tuple(replicated_basis(k, n, padded_size(n, ns), mesh)
                 for k in kinds for n in (h, w))


@functools.partial(jax.jit, static_argnames=("mesh", "config", "quantize", "h"))
def _embed_spatial_jit(rgb, marks, bases, mesh, config, quantize, h):
    # ``rgb`` arrives with its rows already zero-padded to divisibility and
    # row-sharded (see _place_row_sharded); ``h`` is the true height.
    # ``bases`` is (ch, cw, dh, dw) from _spatial_bases.
    w = rgb.shape[1]
    n = mesh.shape[SPATIAL_AXIS]
    wp = padded_size(w, n)
    hp = rgb.shape[0]
    yiq = colorspace.rgb_to_yiq(pipeline._to_f32(rgb))
    # Arbitrary sizes (the reference handles any W x H, src/dct2d.rs:83-98):
    # pad the luma plane up to divisibility; the zero-extended bases keep the
    # padding inert, the top-k masks it out, and the result is cropped.
    y_pad = _pad_last2(yiq[..., 0], hp, wp)
    coeffs = dct2_2d_sharded_padded(y_pad, mesh, bases[:2],
                                    precision=config.precision)
    coeffs = _modulate_sharded(coeffs, marks, mesh, config, h, w)
    y = idct2_2d_sharded_padded(coeffs, mesh, h, w, bases[2:],
                                precision=config.precision)[..., :h, :w]
    out = colorspace.yiq_to_rgb(
        jnp.concatenate([y[..., None], yiq[..., :h, :, 1:]], axis=-1))
    if quantize:
        out = colorspace.f32_to_u8(out)
    return out


def _place_row_sharded(img, mesh: Mesh):
    """Zero-pad rows to spatial-axis divisibility and place P(spatial, ...).

    Padding happens on the host BEFORE device_put so the image is always
    genuinely row-sharded -- a replicated fallback would reinstate the
    per-device memory ceiling for exactly the images this path exists for
    (single images too large for one chip).
    """
    import numpy as np

    nsp = mesh.shape[SPATIAL_AXIS]
    hp = padded_size(img.shape[0], nsp)
    if hp != img.shape[0]:
        img = np.asarray(img)
        img = np.pad(img, ((0, hp - img.shape[0]),) + ((0, 0),) * (img.ndim - 1))
    return jax.device_put(
        img, NamedSharding(mesh, P(*((SPATIAL_AXIS,) + (None,) * (img.ndim - 1)))))


def embed_spatial(rgb, marks, mesh: Mesh,
                  config: WriteConfig = WriteConfig(), quantize=True):
    """TP embed of ONE (H, W, 3) image sharded spatially over the mesh.

    Any H x W is accepted (non-divisible sizes are zero-padded on the host,
    mirroring the reference's arbitrary-size support, src/dct2d.rs:83-98, and
    then row-sharded so no device ever holds the full image). Returns the
    (H, W, 3) result.
    """
    if marks.ndim == 1:
        marks = marks[None]
    h, w = rgb.shape[:2]
    rgb = _place_row_sharded(rgb, mesh)
    marks = jax.device_put(marks, NamedSharding(mesh, P()))
    bases = _spatial_bases(mesh, h, w, ("dct2", "dct3"))
    return _embed_spatial_jit(rgb, marks, bases, mesh, config, quantize, h)


@functools.partial(jax.jit, static_argnames=("mesh", "config", "n", "h"))
def _extract_spatial_jit(base, derived, bases, n, mesh, config, h):
    # Inputs arrive row-padded to divisibility and row-sharded; ``h`` is the
    # true height (see _place_row_sharded); ``bases`` is (ch, cw).
    w = base.shape[1]
    nspatial = mesh.shape[SPATIAL_AXIS]
    hp, wp = base.shape[0], padded_size(w, nspatial)
    yb = _pad_last2(colorspace.rgb_to_yiq(pipeline._to_f32(base))[..., 0], hp, wp)
    yd = _pad_last2(colorspace.rgb_to_yiq(pipeline._to_f32(derived))[..., 0], hp, wp)
    cb = dct2_2d_sharded_padded(yb, mesh, bases, precision=config.precision)
    cd = dct2_2d_sharded_padded(yd, mesh, bases, precision=config.precision)

    def local(cb_blk, cd_blk):
        wb = cb_blk.shape[1]
        my_id = jax.lax.axis_index(SPATIAL_AXIS)
        idx = distributed_top_indices(cb_blk, n, config.ordering, h, w)
        rows, cols = idx // w, idx % w
        owner = cols // wb
        local_flat = rows * wb + (cols - my_id * wb)
        mine = owner == my_id
        safe = jnp.where(mine, local_flat, 0)
        bvals = jax.lax.psum(
            jnp.where(mine, cb_blk.reshape(-1)[safe], 0.0), SPATIAL_AXIS)
        dvals = jax.lax.psum(
            jnp.where(mine, cd_blk.reshape(-1)[safe], 0.0), SPATIAL_AXIS)
        if config.custom_extract is not None:
            return config.custom_extract(idx, bvals, dvals)
        return modulation.extract_values(
            config.extraction.method, config.extraction.alpha, bvals, dvals)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(None, SPATIAL_AXIS), P(None, SPATIAL_AXIS)),
        out_specs=P(None),
    )(cb, cd)


def extract_spatial(base, derived, n: int, mesh: Mesh,
                    config: ReadConfig = ReadConfig()):
    """TP extract from ONE huge image pair sharded spatially over the mesh."""
    if base.shape != derived.shape:
        raise ValueError(
            "Derived coefficient length not equal to base coefficient length.")
    if n >= base.shape[0] * base.shape[1]:
        raise ValueError("Desired extraction length exceeds available coefficients.")
    h, w = base.shape[:2]
    base = _place_row_sharded(base, mesh)
    derived = _place_row_sharded(derived, mesh)
    bases = _spatial_bases(mesh, h, w, ("dct2",))
    return _extract_spatial_jit(base, derived, bases, n, mesh, config, h)


# ---------------------------------------------------------------------------
# Joint DP x TP corpus pipelines (BASELINE config 5)
# ---------------------------------------------------------------------------


def _corpus_forward(rgb_blk, ch, cw, precision):
    """Local (Bl, Hp/s, W, 3) row block -> (Bl, Hp, Wp/s) column-sharded
    coefficients: luma, local row pass over W, one all-to-all over the
    spatial axis, local column pass over H. The batch axis rides along."""
    p = jax_precision(precision)
    y = colorspace.rgb_to_luma(pipeline._to_f32(rgb_blk))  # (Bl, Hl, W)
    wp = cw.shape[0]
    if y.shape[-1] != wp:
        y = jnp.pad(y, ((0, 0), (0, 0), (0, wp - y.shape[-1])))
    t = jnp.einsum("...hw,lw->...hl", y, cw, precision=p)
    t = jax.lax.all_to_all(t, SPATIAL_AXIS, split_axis=t.ndim - 1,
                           concat_axis=t.ndim - 2, tiled=True)
    return jnp.einsum("km,...mw->...kw", ch, t, precision=p)


def _gather_replicated(coef_blk, idx, width):
    """Replicated (n,) values at global flat ``idx`` from a (Hp, Wp/s)
    column block (psum of the owner's gathers)."""
    wb = coef_blk.shape[-1]
    my_id = jax.lax.axis_index(SPATIAL_AXIS)
    rows, cols = idx // width, idx % width
    mine = (cols // wb) == my_id
    local_flat = rows * wb + (cols - my_id * wb)
    safe = jnp.where(mine, local_flat, 0)
    vals = jnp.where(mine, coef_blk.reshape(-1)[safe], 0.0)
    return jax.lax.psum(vals, SPATIAL_AXIS)


@functools.partial(
    jax.jit, static_argnames=("mesh", "config", "h", "w"))
def _embed_corpus_jit(rgb, marks, bases, mesh, config, h, w):
    # ``bases``: ch (Hp, Hp), cw (Wp, Wp), and the inverse bases
    # dh_pad (Hp, Hp) and dw (W, W), indexed [pixel, coeff]; dh_pad's
    # padding pixel rows are zero (dY is 0 there).
    ch, cw, dh_pad, dw = bases
    p = jax_precision(config.precision)

    def local(rgb_blk, marks_blk, ch, cw, dh_pad, dw):
        coef = _corpus_forward(rgb_blk, ch, cw, config.precision)
        n = marks_blk.shape[-1]

        def rank_and_modulate(coef_img, mark):
            idx = distributed_top_indices(coef_img, n, config.ordering, h, w)
            original = _gather_replicated(coef_img, idx, w)
            new_values = modulation.embed_marks(
                original, mark, config.insertion.method,
                config.insertion.alpha, custom_insert=config.custom_insert,
                indices=idx)
            return idx, new_values - original

        idx, delta = jax.vmap(rank_and_modulate)(coef, marks_blk)

        # Local sparse delta-IDCT: this device owns rows
        # [row0, row0 + Hl) of every image; dY for those rows is one
        # (Hl, n) x (n, W) matmul from the REPLICATED (idx, delta) --
        # no second all-to-all, no full inverse transform.
        hl = rgb_blk.shape[1]
        row0 = jax.lax.axis_index(SPATIAL_AXIS) * hl
        dh_loc = jax.lax.dynamic_slice(dh_pad, (row0, 0),
                                       (hl, dh_pad.shape[1]))

        def inverse(idx_img, delta_img):
            rows_i, cols_i = idx_img // w, idx_img % w
            a = jnp.take(dh_loc, rows_i, axis=1)   # (Hl, n)
            bmat = jnp.take(dw, cols_i, axis=1)    # (W, n)
            return jnp.einsum("hn,wn->hw", a * delta_img[None, :], bmat,
                              precision=p) * (4.0 / (w * h))

        dy = jax.vmap(inverse)(idx, delta)          # (Bl, Hl, W)
        out = jnp.clip(pipeline._to_f32(rgb_blk) + dy[..., None], 0.0, 1.0)
        return colorspace.f32_to_u8(out)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, SPATIAL_AXIS, None, None), P(DATA_AXIS, None),
                  P(None, None), P(None, None), P(None, None), P(None, None)),
        out_specs=P(DATA_AXIS, SPATIAL_AXIS, None, None),
    )(rgb, marks, *bases)


@functools.partial(jax.jit, static_argnames=("mesh", "config", "n", "h", "w"))
def _extract_corpus_jit(base, derived, bases, n, mesh, config, h, w):
    wp = bases[1].shape[0]

    def local(base_blk, derived_blk, ch, cw):
        cb = _corpus_forward(base_blk, ch, cw, config.precision)
        # The extraction equations consume derived - base (or their ratio);
        # the DCT is linear, so transform the luma DIFFERENCE once instead
        # of the derived image separately (exact integer luma difference for
        # u8 pairs -- see ops/colorspace.luma_diff).
        ydiff = colorspace.luma_diff(base_blk, derived_blk)
        if ydiff.shape[-1] != wp:
            ydiff = jnp.pad(ydiff, ((0, 0), (0, 0), (0, wp - ydiff.shape[-1])))
        p = jax_precision(config.precision)
        t = jnp.einsum("...hw,lw->...hl", ydiff, cw, precision=p)
        t = jax.lax.all_to_all(t, SPATIAL_AXIS, split_axis=t.ndim - 1,
                               concat_axis=t.ndim - 2, tiled=True)
        cd = jnp.einsum("km,...mw->...kw", ch, t, precision=p)

        def one(cb_img, cd_img):
            idx = distributed_top_indices(cb_img, n, config.ordering, h, w)
            bvals = _gather_replicated(cb_img, idx, w)
            dnum = _gather_replicated(cd_img, idx, w)
            if config.custom_extract is not None:
                return config.custom_extract(idx, bvals, bvals + dnum)
            return modulation.extract_values(
                config.extraction.method, config.extraction.alpha,
                bvals, bvals + dnum)

        return jax.vmap(one)(cb, cd)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, SPATIAL_AXIS, None, None),
                  P(DATA_AXIS, SPATIAL_AXIS, None, None),
                  P(None, None), P(None, None)),
        out_specs=P(DATA_AXIS, None),
    )(base, derived, *bases)


def _place_corpus(imgs, mesh: Mesh):
    """Host-pad rows to spatial divisibility and place the batch
    P(data, spatial, None, None): every device holds (B/d, Hp/s, W, 3)."""
    import numpy as np

    ns = mesh.shape[SPATIAL_AXIS]
    hp = padded_size(imgs.shape[1], ns)
    if hp != imgs.shape[1]:
        imgs = np.asarray(imgs)
        imgs = np.pad(imgs, ((0, 0), (0, hp - imgs.shape[1]), (0, 0), (0, 0)))
    return jax.device_put(
        imgs, NamedSharding(mesh, P(DATA_AXIS, SPATIAL_AXIS, None, None)))


def embed_corpus(rgb, marks, mesh: Mesh, config: WriteConfig = WriteConfig()):
    """Joint DP x TP embed of a corpus of huge images (BASELINE config 5).

    ``rgb``: (B, H, W, 3) with B divisible by the data axis; ``marks``:
    (B, n), one mark per image. Returns (B, Hp, W, 3) uint8, where rows
    >= H are zero padding (crop with ``[:, :H]`` on the host); keeping the
    padded layout lets extract_corpus consume the result without a reshard.
    """
    if marks.ndim != 2:
        raise ValueError("embed_corpus takes (B, n) marks, one per image")
    h, w = rgb.shape[1], rgb.shape[2]
    rgb = _place_corpus(rgb, mesh)
    marks = jax.device_put(marks, NamedSharding(mesh, P(DATA_AXIS, None)))
    bases = (*_spatial_bases(mesh, h, w, ("dct2",)),
             replicated_basis("dct3", h, rgb.shape[1], mesh),
             replicated_basis("dct3", w, w, mesh))
    return _embed_corpus_jit(rgb, marks, bases, mesh, config, h, w)


def extract_corpus(base, derived, n: int, mesh: Mesh,
                   config: ReadConfig = ReadConfig(), *, height=None):
    """Joint DP x TP extract over a corpus: (B, n) marks, one per image.

    ``base``/``derived``: (B, H, W, 3) or the (B, Hp, W, 3) padded output of
    :func:`embed_corpus` (pass the true ``height`` then).
    """
    if base.shape != derived.shape:
        raise ValueError(
            "Derived coefficient length not equal to base coefficient length.")
    h = height if height is not None else base.shape[1]
    w = base.shape[2]
    if n >= h * w:
        raise ValueError("Desired extraction length exceeds available coefficients.")
    base = _place_corpus(base, mesh)
    derived = _place_corpus(derived, mesh)
    bases = _spatial_bases(mesh, h, w, ("dct2",))
    return _extract_corpus_jit(base, derived, bases, n, mesh, config, h, w)
