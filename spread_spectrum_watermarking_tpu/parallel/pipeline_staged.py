"""Pipeline-parallel (staged) embed: GPipe-style microbatch schedule.

The reference computes color -> DCT -> rank -> modulate -> IDCT serially in
one thread (SURVEY.md section 2.1 marks pipeline parallelism absent there and
optional here). This module stages that chain across a ``stage`` mesh axis so
different devices work on different microbatches' stages concurrently:

    stage 0: u8 RGB -> integer luma -> first DCT-II pass        (1 dot)
    stage 1: second pass -> rank -> modulate -> sparse delta    (1 dot)
    stage 2: sparse delta-IDCT -> add -> clip -> quantize       (skinny dot)

Activations move with one ``lax.ppermute`` per tick: stage 0 -> 1 carries the
(B, H, W) bf16 half-transformed plane; stage 1 -> 2 only the (B, n) delta and
indices. The schedule is the textbook GPipe fill-drain: with M microbatches
and S stages, M + S - 1 ticks, bubble fraction (S-1)/(M+S-1).

The staged result is bit-identical to the fast-path :func:`..models.pipeline.
embed` per microbatch (pinned in tests/test_sharded.py): the stage bodies ARE
the production pipeline's stages, so this is purely an execution-schedule
experiment, not a numerics fork.

Measured verdict (recorded for BASELINE config completeness): on this
workload data parallelism dominates. Measured on the 8-virtual-device CPU
mesh (12 microbatches x 2 images of 256x384, n=200): 3-stage PP 92.1 ms vs
3-device DP 31.9 ms on the *same* devices -- PP/DP = 2.9x, outputs
bit-identical. The reasons are structural, not tuning: PP moves a bf16
half-plane activation between stages per microbatch where DP moves nothing,
the three stages are FLOP-imbalanced (two full-plane dots vs one skinny
dot), and the fill/drain bubble wastes (S-1)/(M+S-1) of the schedule --
whereas the batch axis is embarrassingly parallel (reference images are
independent, src/algorithm.rs:295-316 holds per-image state only). Keep
``data`` (+ ``spatial`` for single huge images) as the production axes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Precision, WriteConfig
from ..models import pipeline
from ..ops import colorspace, modulation

STAGE_AXIS = "stage"
N_STAGES = 3


def make_stage_mesh(n_stages: int = N_STAGES, devices=None) -> Mesh:
    """A 1-D mesh whose only axis is the pipeline stage."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    if len(devices) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n_stages]), (STAGE_AXIS,))


def _stage0(mb_u8, config: WriteConfig):
    """u8 (B, H, W, 3) -> first-pass plane, matching _rank_and_values_fast's
    prologue axis choice (bit-identity contract: the stage runs the same
    code the fast path does)."""
    h, w = mb_u8.shape[-3], mb_u8.shape[-2]
    ax = pipeline._shorter_axis(h, w)
    return pipeline._half_pass(mb_u8, config.precision, ax)


def _stage1(t, marks, config: WriteConfig, h: int, w: int):
    """Half-transformed plane -> (delta, idx): second pass, rank, modulate.

    The pass/rank numerics are pipeline._rank_from_half itself -- shared
    code, so staged and single-device results are bit-identical.
    """
    ax = pipeline._shorter_axis(h, w)
    idx, original = pipeline._rank_from_half(
        t, marks.shape[-1], config.ordering, config.custom_ordering, ax,
        config.rank_version)
    if marks.ndim == 2:
        marks = jnp.broadcast_to(marks[None],
                                 (original.shape[0],) + marks.shape)
    new_values = modulation.embed_marks(
        original, marks, config.insertion.method, config.insertion.alpha,
        custom_insert=config.custom_insert, indices=idx)
    return new_values - original, idx


def _stage2(mb_u8, delta, idx, config: WriteConfig):
    """(delta, idx) + original u8 -> watermarked u8 (the embed epilogue)."""
    h, w = mb_u8.shape[-3], mb_u8.shape[-2]
    dy = pipeline._sparse_idct_delta(delta, idx, h, w, Precision.DEFAULT)
    return colorspace.add_luma_delta_u8(mb_u8, dy)


@functools.partial(jax.jit, static_argnames=("mesh", "config"))
def _embed_staged_jit(images, marks, mesh, config):
    m, bmb, h, w, _ = images.shape
    n = marks.shape[-1]
    ax = pipeline._shorter_axis(h, w)
    t_shape = (bmb, h, w)  # half-pass output keeps the (H, W) block shape

    def per_device(images_rep, marks_rep):
        sid = jax.lax.axis_index(STAGE_AXIS)

        def tick(t_i, carry):
            out_buf, act = carry
            # Which microbatch this device's stage touches this tick.
            mb_id = t_i - sid
            valid = (mb_id >= 0) & (mb_id < m)
            mb = jax.lax.dynamic_index_in_dim(
                images_rep, jnp.clip(mb_id, 0, m - 1), 0, keepdims=False)

            zero_out = jnp.zeros((bmb, h, w, 3), jnp.uint8)

            def run_stage0(act):
                t = _stage0(mb, config)
                return dict(act, t=t.astype(jnp.bfloat16)), zero_out

            def run_stage1(act):
                delta, idx = _stage1(act["t"], marks_rep, config, h, w)
                return dict(act, delta=delta, idx=idx), zero_out

            def run_stage2(act):
                return act, _stage2(mb, act["delta"], act["idx"], config)

            def idle(act):
                return act, zero_out

            act, out_mb = jax.lax.cond(
                valid,
                lambda a: jax.lax.switch(
                    sid, [run_stage0, run_stage1, run_stage2], a),
                idle, act)

            # Stage 2 writes its finished microbatch into the output buffer
            # (other stages' writes are masked to a no-op index update of
            # the same value).
            write = valid & (sid == N_STAGES - 1)
            safe_id = jnp.clip(mb_id, 0, m - 1)
            cur = jax.lax.dynamic_index_in_dim(out_buf, safe_id, 0,
                                               keepdims=False)
            out_buf = jax.lax.dynamic_update_index_in_dim(
                out_buf, jnp.where(write, out_mb, cur), safe_id, 0)

            # Shift each activation only along the edge that consumes it:
            # the bf16 half-plane moves 0 -> 1, the (delta, idx) pair moves
            # 1 -> 2 -- halving inter-stage traffic vs shifting the whole
            # pytree on every edge. Non-receiving devices get zeros; the
            # last stage's send has no receiver.
            act = {
                "t": jax.lax.ppermute(act["t"], STAGE_AXIS, [(0, 1)]),
                "delta": jax.lax.ppermute(act["delta"], STAGE_AXIS, [(1, 2)]),
                "idx": jax.lax.ppermute(act["idx"], STAGE_AXIS, [(1, 2)]),
            }
            return out_buf, act

        out_buf = jnp.zeros((m, bmb, h, w, 3), jnp.uint8)
        act = {
            "t": jnp.zeros(t_shape, jnp.bfloat16),
            "delta": jnp.zeros((bmb, n), jnp.float32),
            "idx": jnp.zeros((bmb, n), jnp.int32),
        }
        out_buf, _ = jax.lax.fori_loop(
            0, m + N_STAGES - 1, tick, (out_buf, act))
        # Per-device (M, ...) buffers stack to a leading stage axis; only the
        # last stage's slice holds data (the caller takes [-1]).
        return out_buf[None]

    return shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(STAGE_AXIS),
        check_vma=False,
    )(images, marks)


def embed_staged(images, marks, mesh: Mesh,
                 config: WriteConfig = WriteConfig(
                     precision=Precision.DEFAULT)):
    """Pipeline-parallel embed of (M, B_mb, H, W, 3) u8 microbatches.

    ``marks``: (N,) or (MARKS, N), shared across images (per-image marks are
    a DP concern; this is a schedule experiment -- see module docstring).
    Returns (M, B_mb, H, W, 3) u8, bit-identical to the fast-path
    :func:`..models.pipeline.embed` applied per microbatch.

    Requires a non-HIGHEST precision config (the staged bodies are the fast
    path's stages; the HIGHEST tier is the reference-exact single-device
    parity path and is not staged).
    """
    if config.precision is Precision.HIGHEST:
        raise ValueError("staged embed requires a fast-tier precision "
                         "(DEFAULT or HIGH)")
    if marks.ndim == 1:
        marks = marks[None]
    images = jax.device_put(images, NamedSharding(mesh, P()))
    marks = jax.device_put(marks, NamedSharding(mesh, P()))
    out = _embed_staged_jit(images, marks, mesh, config)
    return out[-1]
