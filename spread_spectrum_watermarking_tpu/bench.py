"""Throughput benchmark harness.

Measures embed / extract / embed+extract images-per-second on the default
device. The reference publishes no throughput numbers (SURVEY.md section 6).
The entry points (``bench.py``, ``ssw-tpu bench``) report only from a GPU
(:func:`require_gpu`); the ``run_*`` functions themselves run anywhere, so
the tests drive them on the CPU at small sizes.

Methodology: the iteration loop runs INSIDE one jitted ``lax.scan`` whose
carry chains each iteration's output into the next iteration's input, and the
measurement ends with a host fetch of a carry-dependent scalar. This makes
the timing robust against async dispatch and result caching: the device
provably executed every iteration sequentially before the scalar arrives.
"""

from __future__ import annotations

import functools
import time
from typing import Tuple

import numpy as np

from .config import Precision, ReadConfig, WriteConfig

_SIZES = {
    "1080p": (1080, 1920),
    "720p": (720, 1280),
    "4k": (2160, 3840),
    "cat": (444, 640),
}


def device_info() -> dict:
    """The default device as JAX reports it."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def require_gpu() -> dict:
    """:func:`device_info`, or ``RuntimeError`` unless the default device is
    a GPU: a benchmark number from any other backend is not reported."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"benchmarks run only on a GPU; JAX's default device is "
            f"{info['platform']} ({info['device_kind']})")
    return info


def parse_size(size: str) -> Tuple[int, int]:
    if size.lower() in _SIZES:
        return _SIZES[size.lower()]
    h, w = size.lower().split("x")
    return int(h), int(w)


def _timed_scan(step_fn, carry, iters: int) -> float:
    """Time chained executions of step_fn inside one XLA program.

    ``step_fn(carry) -> carry`` must thread a data dependency through the
    carry, which makes async-dispatch / result-caching inflation impossible
    (each iteration provably executed before the fetched scalar arrives).

    Returns seconds per iteration as the SLOPE between two scan lengths,
    ``(t(iters) - t(iters//8)) / (iters - iters//8)``: a single timing also
    contains the fixed dispatch + scalar-fetch cost of one call, which the
    slope cancels.
    """
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n",))
    def loop(c, n):
        def body(c, _):
            return step_fn(c), None

        c, _ = jax.lax.scan(body, c, None, length=n)
        return c

    def fetch(c):
        leaf = jax.tree_util.tree_leaves(c)[0]
        return float(jnp.sum(leaf[..., 0].astype(jnp.float32)))

    iters = max(iters, 2)
    n_short = max(1, iters // 8)

    def timed(n):
        # min-of-2: the fixed per-call cost carries jitter that is strictly
        # additive, so the minimum is the right estimator -- one noisy
        # sample per length can otherwise push the slope negative on
        # programs whose whole slope segment is smaller than the jitter.
        fetch(loop(carry, n))  # compile + warm
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            fetch(loop(carry, n))
            best = min(best, time.perf_counter() - t0)
        return best

    # Self-calibrate: grow the scan until the slope segment is comfortably
    # above the per-call jitter, else a microseconds-per-iter program
    # yields a segment indistinguishable from zero and the slope is noise.
    t_short, t_long = timed(n_short), timed(iters)
    while (t_long - t_short) < 0.05 and iters < 65536:
        n_short, t_short = iters, t_long
        iters *= 4
        t_long = timed(iters)
    slope = (t_long - t_short) / (iters - n_short)
    if slope <= 0.0:
        # Refuse to fabricate: even 65536 chained iterations stayed inside
        # the timing jitter, so no honest per-iteration number exists.
        raise RuntimeError(
            f"step too fast to slope-time: {iters} iterations added only "
            f"{1e3 * (t_long - t_short):.2f} ms over {n_short}")
    return slope


def run_bench(batch: int = 32, size: str = "1080p", length: int = 1000,
              iters: int = 10, precision: str = "high",
              profile_dir: str | None = None,
              content: str = "noise") -> dict:
    """Measure embed/extract throughput; optionally write a ``jax.profiler``
    trace (the pipeline stages carry ``ssw.forward`` / ``ssw.rank`` /
    ``ssw.inverse`` annotations).

    ``content`` selects the input statistics: ``"noise"`` (uniform u8) or
    ``"natural"`` (1/f-texture mosaic crops via
    :func:`natural_corpus_chunk`)."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from .models import pipeline

    profile_cm = (jax.profiler.trace(profile_dir) if profile_dir
                  else contextlib.nullcontext())

    h, w = parse_size(size)
    prec = Precision(precision)
    wcfg = WriteConfig(precision=prec)
    rcfg = ReadConfig(precision=prec)

    rng = np.random.default_rng(0)
    if content == "natural":
        images = jnp.asarray(natural_corpus_chunk(batch, h, w, rng))
    else:
        images = jnp.asarray(
            rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8))
    marks = jnp.asarray(
        rng.standard_normal((batch, 1, length)).astype(np.float32))

    # --- embed: chain watermarked u8 output back in as the next input ---
    with profile_cm:
        t_embed = _timed_scan(
            lambda imgs: pipeline.embed(imgs, marks, wcfg), images, iters)

        marked = pipeline.embed(images, marks, wcfg)

        # --- extract (full read path) on u8 derived images -- the dtype
        # users actually read back from disk.
        # Both base and derived thread through the scan carry: closing over
        # the 190 MB base batch would make it a program constant, whose
        # staging is outside the pipeline and would pollute the number. ---

        def extract_step(carry):
            base, derived = carry
            ext = pipeline.extract(base, derived, length, rcfg)
            # Data-dependence without perturbation: ext is ~O(1) at runtime,
            # so ext[0,0] * 1e30 underflows the uint8 cast to exactly 0 and
            # the xor is a bit-exact identity -- each iteration extracts
            # from the *identical* u8 derived batch. Only ONE element is
            # touched: xor-ing the whole batch adds read+write traffic that
            # belongs to the harness, not the pipeline; the scalar update
            # carries the same dependence (derived' <- ext) at in-place DUS
            # cost.
            flip = (ext[0, 0] * 1e-30).astype(jnp.uint8)
            return base, derived.at[0, 0, 0, 0].set(
                derived[0, 0, 0, 0] ^ flip)

        t_extract = _timed_scan(extract_step, (images, marked), iters)

    embeds_per_sec = batch / t_embed
    extracts_per_sec = batch / t_extract
    combined_per_sec = batch / (t_embed + t_extract)

    return {
        "size": f"{h}x{w}",
        "batch": batch,
        "length": length,
        "precision": prec.value,
        "content": content,
        "embed_images_per_sec": embeds_per_sec,
        "extract_images_per_sec": extracts_per_sec,
        "embed_extract_images_per_sec": combined_per_sec,
        "embed_ms_per_image": 1e3 * t_embed / batch,
        "extract_ms_per_image": 1e3 * t_extract / batch,
    }


def run_latency_bench(size: str = "1080p", length: int = 1000,
                      precision: str = "default", iters: int = 256) -> dict:
    """Single-image (batch-1) latency, device-side.

    The throughput configs batch 48 because small batches leave the device
    mostly idle; this config records what a latency-sensitive single-stream
    user actually gets per image. Device-side scan timing (run_bench
    methodology at batch 1) -- the client-observed number additionally pays
    one host->device->host round trip.
    """
    res = run_bench(batch=1, size=size, length=length, iters=iters,
                    precision=precision)
    return {
        "size": res["size"], "length": length, "precision": res["precision"],
        "embed_latency_ms": res["embed_ms_per_image"],
        "extract_latency_ms": res["extract_ms_per_image"],
        "single_stream_embed_per_sec": res["embed_images_per_sec"],
    }


def run_cached_extract_bench(batch: int = 32, size: str = "1080p",
                             length: int = 1000, iters: int = 64,
                             precision: str = "default") -> dict:
    """Reader-cached extraction: one set of originals served against a stream
    of derived images.

    The reference CLI caches the base reader's work (coefficients + ranked
    indices) and re-derives only the watermarked image per test
    (examples/main.rs:369-412). Here the cached work is
    :func:`..models.pipeline.rank_base` (the fast prologue's indices + value
    estimates) and each derived image costs only the delta-exact diff
    transform + gather-dot (:func:`..models.pipeline.extract_ranked`) -- the
    steady-state cost of a detection service whose originals are fixed.
    Fast (non-HIGHEST) tiers only.
    """
    import jax
    import jax.numpy as jnp

    from .models import pipeline

    h, w = parse_size(size)
    prec = Precision(precision)
    if prec is Precision.HIGHEST:
        raise ValueError("cached-extract bench measures the fast tiers")
    wcfg = WriteConfig(precision=prec)
    rcfg = ReadConfig(precision=prec)

    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8))
    marks = jnp.asarray(
        rng.standard_normal((batch, 1, length)).astype(np.float32))
    marked = pipeline.embed(images, marks, wcfg)
    idx, vals = pipeline.rank_base(images, length, rcfg)

    def step(carry):
        base, derived, idx, vals = carry
        ext = pipeline.extract_ranked(base, derived, idx, vals, rcfg)
        # Bit-exact identity data dependence (see run_bench.extract_step).
        flip = (ext[0, 0] * 1e-30).astype(jnp.uint8)
        return (base, derived.at[0, 0, 0, 0].set(derived[0, 0, 0, 0] ^ flip),
                idx, vals)

    t = _timed_scan(step, (images, marked, idx, vals), iters)
    return {
        "size": f"{h}x{w}", "batch": batch, "length": length,
        "precision": prec.value,
        "cached_extract_images_per_sec": batch / t,
        "extract_ms_per_image": 1e3 * t / batch,
    }


def run_verified_bench(batch: int = 32, size: str = "1080p",
                       length: int = 1000, iters: int = 64,
                       precision: str = "default") -> dict:
    """Fused embed+verify (:func:`..models.pipeline.embed_verified`): the
    reference CLI's ``-p`` round trip as ONE XLA program sharing the base
    prologue between the write and read sides. Measures images/sec for the
    full mark-then-confirm cycle (cf. run_bench's separate-programs
    embed_extract_images_per_sec, which re-derives the base for the read)."""
    import jax
    import jax.numpy as jnp

    from .models import pipeline

    h, w = parse_size(size)
    prec = Precision(precision)
    wcfg = WriteConfig(precision=prec)

    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8))
    marks = jnp.asarray(
        rng.standard_normal((batch, 1, length)).astype(np.float32))

    def step(imgs):
        marked, ext = pipeline.embed_verified(imgs, marks, wcfg)
        # Chain: next iteration embeds into this iteration's output, with a
        # data dependence on the extraction too (single-element identity
        # xor, see run_bench.extract_step).
        flip = (ext[0, 0] * 1e-30).astype(jnp.uint8)
        return marked.at[0, 0, 0, 0].set(marked[0, 0, 0, 0] ^ flip)

    t = _timed_scan(step, images, iters)
    return {
        "size": f"{h}x{w}", "batch": batch, "length": length,
        "precision": prec.value,
        "embed_verified_images_per_sec": batch / t,
        "ms_per_image": 1e3 * t / batch,
    }


_SWEEP_PRECISIONS = {"highest": "HIGHEST", "high": "HIGH",
                     "default": "DEFAULT"}


def run_similarity_sweep_bench(n_extracted: int = 1024, n_marks: int = 10000,
                               length: int = 1000, iters: int = 400,
                               precision: str = "highest") -> dict:
    """The 10k-watermark similarity sweep (BASELINE.json config 4): one matmul.

    The sweep is a sub-millisecond program, the case :func:`_timed_scan`'s
    slope methodology exists for: a naive dispatch loop times the enqueue,
    not the device, which is why none of the numbers in this module are
    timed that way.

    ``precision``: matmul precision for the sweep -- "highest" (IEEE f32,
    the library default) or "high"/"default" (both TF32 on an H100; the
    error against float64 is printed by ``chip_smoke.py``).
    """
    import jax
    import jax.numpy as jnp

    from .ops import modulation

    prec = getattr(jax.lax.Precision, _SWEEP_PRECISIONS[precision])
    rng = np.random.default_rng(1)
    ext = jnp.asarray(rng.standard_normal((n_extracted, length)), dtype=jnp.float32)
    marks = jnp.asarray(rng.standard_normal((n_marks, length)), dtype=jnp.float32)

    def step(e):
        sims = modulation.similarity(e, marks, precision=prec)
        return e + sims[0, 0] * 1e-30

    t = _timed_scan(step, ext, iters)
    return {"similarity_pairs_per_sec": n_extracted * n_marks / t,
            "seconds": t, "precision": precision}


def _pink_texture(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 3) u8 texture with a 1/f amplitude spectrum -- the standard
    natural-image statistics model."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    out = np.empty((h, w, 3), np.uint8)
    for c in range(3):
        phase = rng.random((h, fx.shape[1])) * 2.0 * np.pi
        spec = (1.0 / f ** 1.2) * np.exp(1j * phase)
        img = np.fft.irfft2(spec, s=(h, w))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        out[..., c] = (img * 255.0).astype(np.uint8)
    return out


def natural_corpus_chunk(chunk: int, h: int, w: int, rng) -> np.ndarray:
    """(chunk, h, w, 3) u8 corpus chunk with natural-image statistics.

    Each image is a distinct random crop of a mosaic of one 1/f-spectrum
    texture made from ``rng`` (flips + brightness/contrast jitter per
    image), so the coefficient-energy spectrum the ranking sees is a natural
    image's -- not the dense flat spectrum of uniform noise, which is the
    friendliest possible content for energy-ranked spread-spectrum
    embedding.
    """
    src = _pink_texture(rng, 512, 512)
    sh, sw = src.shape[:2]
    reps_h = -(-(h + 256) // sh)
    reps_w = -(-(w + 256) // sw)
    canvas = np.tile(src, (reps_h, reps_w, 1))
    imgs = np.empty((chunk, h, w, 3), np.uint8)
    for i in range(chunk):
        oy = int(rng.integers(0, canvas.shape[0] - h + 1))
        ox = int(rng.integers(0, canvas.shape[1] - w + 1))
        img = canvas[oy:oy + h, ox:ox + w]
        if rng.integers(2):
            img = img[:, ::-1]
        if rng.integers(2):
            img = img[::-1]
        gain = 0.8 + 0.4 * rng.random()
        bias = float(rng.integers(-16, 17))
        imgs[i] = np.clip(
            img.astype(np.float32) * gain + bias, 0.0, 255.0).astype(np.uint8)
    return imgs


def run_corpus_bench(n_images: int = 1024, chunk: int = 64, size: str = "1080p",
                     length: int = 1000, precision: str = "high",
                     n_marks: int = 10000) -> dict:
    """BASELINE.json config 4 end-to-end: embed+extract a 1024-image 1080p
    corpus in device-resident chunks, then sweep every extraction against a
    10k-watermark database in one (B,N)@(N,K) matmul.

    Unlike :func:`run_bench` (steady-state scan timing), this wall-clocks the
    real corpus loop: per-chunk embed -> extract -> 10k-sweep with the
    (chunk, n_marks) similarity matrix fetched to the host every chunk. The
    corpus content is natural-image statistics (:func:`natural_corpus_chunk`)
    and stays device-resident (each chunk is a cheap device-side roll of the
    base chunk, which preserves those statistics), so host->device transfers
    of the images are not part of the number.
    """
    import jax
    import jax.numpy as jnp

    from .models import pipeline
    from .ops import modulation

    h, w = parse_size(size)
    prec = Precision(precision)
    wcfg = WriteConfig(precision=prec)
    rcfg = ReadConfig(precision=prec)

    rng = np.random.default_rng(2)
    marks_db = jnp.asarray(
        rng.standard_normal((n_marks, length)).astype(np.float32))
    # Each image gets a distinct mark from the database (its row index).
    base_chunk = jnp.asarray(natural_corpus_chunk(chunk, h, w, rng))

    @jax.jit
    def process(imgs, shift, mrk):
        # Distinct content per chunk, device-side: a 2-D circular roll keeps
        # the photograph's statistics (unlike the old u8 '+ shift', which
        # wrapped mod 256 and varied nothing but a bias).
        imgs = jnp.roll(imgs, (shift, 7 * shift), axis=(1, 2))
        marked = pipeline.embed(imgs, mrk[:, None, :], wcfg)
        ext = pipeline.extract(imgs, marked, length, rcfg)
        return modulation.similarity(ext, marks_db)

    n_chunks = n_images // chunk
    zero = jnp.int32(0)
    # Warm/compile on chunk 0.
    process(base_chunk, zero, marks_db[:chunk]).block_until_ready()

    t0 = time.perf_counter()
    best_is_own = 0
    own_sims = []
    # Overlap dispatch with the result stream: JAX dispatch is async, so
    # chunks run back to back on the device while earlier chunks' (chunk,
    # n_marks) similarity matrices stream to the host behind them. The
    # per-chunk synchronous fetch this replaced serialized a full
    # host<->device round trip into every chunk (the work and the fetched
    # bytes are identical -- all n_images embedded, extracted, swept, all
    # sims on the host when the clock stops). The in-flight window is
    # bounded so device memory stays constant at any corpus size (each
    # pending result is chunk x n_marks f32, ~2.5 MB at the default config).
    window = 16

    def consume(offset, sims_dev):
        nonlocal best_is_own
        sims = np.asarray(sims_dev)  # fetch: (chunk, n_marks)
        own = sims[np.arange(chunk), offset + np.arange(chunk)]
        own_sims.append(own)
        best_is_own += int(
            (sims.argmax(axis=1) == offset + np.arange(chunk)).sum())

    pending = []
    for i in range(n_chunks):
        offset = (i * chunk) % (n_marks - chunk)
        pending.append((offset, process(base_chunk, jnp.int32(37 * i),
                                        marks_db[offset:offset + chunk])))
        if len(pending) > window:
            consume(*pending.pop(0))
    for item in pending:
        consume(*item)
    dt = time.perf_counter() - t0

    own_all = np.concatenate(own_sims)
    return {
        "size": f"{h}x{w}", "n_images": n_chunks * chunk, "chunk": chunk,
        "n_marks_swept": n_marks, "precision": prec.value,
        "content": "natural (1/f-texture mosaic crops)",
        "corpus_images_per_sec": n_chunks * chunk / dt,
        "seconds_total": dt,
        "mean_own_mark_sigma": float(own_all.mean()),
        "min_own_mark_sigma": float(own_all.min()),
        "detection_rate_top1": best_is_own / (n_chunks * chunk),
    }


def run_corpus_sharded_bench(n_images: int = 32, chunk: int = 8,
                             size: str = "4k", length: int = 1000,
                             precision: str = "highest",
                             mesh_shape=None) -> dict:
    """BASELINE.json config 5: a 4K corpus over a joint (data, spatial) mesh.

    DP over the image batch, TP (row sharding + sharded DCT + distributed
    top-k + local sparse delta-IDCT) within each image -- see
    parallel/pipeline_sharded.embed_corpus. Runs on whatever devices exist:
    virtual CPU devices in the tests, GPUs unchanged (the collectives are
    NCCL's there).
    """
    import jax
    import jax.numpy as jnp

    from .ops import modulation
    from .parallel import make_mesh
    from .parallel.pipeline_sharded import embed_corpus, extract_corpus

    ndev = len(jax.devices())
    if mesh_shape is None:
        ns = 4 if ndev % 4 == 0 and ndev >= 4 else 1
        mesh_shape = (ndev // ns, ns)
    mesh = make_mesh(tuple(mesh_shape))
    h, w = parse_size(size)
    prec = Precision(precision)
    wcfg = WriteConfig(precision=prec)
    rcfg = ReadConfig(precision=prec)

    rng = np.random.default_rng(3)
    imgs = natural_corpus_chunk(chunk, h, w, rng)
    marks = rng.standard_normal((chunk, length)).astype(np.float32)

    # Warm/compile.
    marked = embed_corpus(jnp.asarray(imgs), jnp.asarray(marks), mesh, wcfg)
    hp = marked.shape[1]
    base_pad = np.pad(imgs, ((0, 0), (0, hp - h), (0, 0), (0, 0)))
    ext = extract_corpus(jnp.asarray(base_pad), marked, length, mesh, rcfg,
                         height=h)
    jax.block_until_ready(ext)

    n_chunks = max(1, n_images // chunk)
    t0 = time.perf_counter()
    sims_all = []
    for i in range(n_chunks):
        marked = embed_corpus(jnp.asarray(imgs), jnp.asarray(marks), mesh, wcfg)
        ext = extract_corpus(jnp.asarray(base_pad), marked, length, mesh,
                             rcfg, height=h)
        sims_all.append(np.asarray(modulation.similarity(
            ext, jnp.asarray(marks))))
    dt = time.perf_counter() - t0

    sims = np.mean(sims_all, axis=0)
    own = np.diag(sims)
    cross = np.abs(sims[~np.eye(chunk, dtype=bool)])
    return {
        "size": f"{h}x{w}", "n_images": n_chunks * chunk, "chunk": chunk,
        "mesh": {"data": mesh.shape["data"], "spatial": mesh.shape["spatial"]},
        "devices": ndev, "platform": jax.devices()[0].platform,
        "precision": prec.value,
        "corpus_images_per_sec": n_chunks * chunk / dt,
        "seconds_total": dt,
        "mean_own_mark_sigma": float(own.mean()),
        "min_own_mark_sigma": float(own.min()),
        "max_cross_mark_sigma": float(cross.max()),
    }
