"""Command-line interface: ``watermark`` and ``test`` + batch/bench extensions.

Mirrors the reference CLI's surface and defaults (reference:
examples/main.rs:135-212): watermark length 1000, alpha 0.1, Option2,
Energy ordering, 6-sigma match threshold; ``<stem>_wm.png``/``_wm.json``
output naming with no-overwrite guards (examples/main.rs:246-265); the
Version1 JSON store with the config embedded (examples/main.rs:284-304); the
legacy ``.wm`` reader; and the YAML-ish result block of the ``test``
subcommand (examples/main.rs:418-429).

Extensions the reference lacks: ``batch`` (embed a directory of images in
batched device programs), ``detect`` (a detection service) and ``bench``
(throughput harness, GPU only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from .config import (InsertExtract, Method, Ordering, Precision, ReadConfig,
                     WriteConfig)
from .utils import image_io, storage

_ORDERING_CHOICES = {
    "energy": Ordering.ENERGY,
    "energy-orthogonal": Ordering.ENERGY_ORTHOGONAL,
    "legacy": Ordering.LEGACY,
}
_METHOD_CHOICES = {
    "option1": Method.OPTION1,
    "option2": Method.OPTION2,
    "option3": Method.OPTION3,
}
_PRECISION_CHOICES = {
    "default": Precision.DEFAULT,
    "high": Precision.HIGH,
    "highest": Precision.HIGHEST,
}


def _add_watermark_config_args(p: argparse.ArgumentParser) -> None:
    # Defaults per reference examples/main.rs:66-70,146-156.
    p.add_argument("--length", type=int, default=1000, help="Watermark length.")
    p.add_argument("--ordering", choices=_ORDERING_CHOICES, default="energy",
                   help="The ordering to be used.")
    p.add_argument("--alpha", type=float, default=0.1,
                   help="Strength, alpha in the equations. For option1 this is "
                        "an absolute (not relative) scaling.")
    p.add_argument("--method", choices=_METHOD_CHOICES, default="option2",
                   help="Method to insert and extract with.")
    _add_precision_arg(p)


def _add_precision_arg(p: argparse.ArgumentParser,
                       for_test: bool = False) -> None:
    if for_test:
        # Extraction must run at the tier the watermark was embedded at
        # (fast-tier rank order is deterministic per tier, not across
        # tiers), so `test` defaults to the tier recorded in each
        # watermark file and the flag is an explicit override.
        p.add_argument("--precision", choices=_PRECISION_CHOICES, default=None,
                       help="Override the transform precision tier. Default: "
                            "the tier recorded in each watermark file "
                            "('highest' for files without one, including "
                            "all reference-written files).")
        p.add_argument("--rank-version", type=int, choices=(1, 2), default=None,
                       help="Override the fast-tier ranking generation instead "
                            "of the one the file's precision spelling implies "
                            "('Default'/'High' = 1, 'Default2'/'High2' = 2). "
                            "Needed for fast-tier marks written by the "
                            "unversioned gather-free builds, which rank at "
                            "generation 2 but carry the unsuffixed spelling: "
                            "read those with --rank-version 2.")
        return
    p.add_argument("--precision", choices=_PRECISION_CHOICES, default="highest",
                   help="Transform precision tier: 'highest' is the "
                        "reference-exact f32 path (default); 'high' and "
                        "'default' are the fast bf16 production tiers "
                        "(fastest: 'default'). The tier is recorded in the "
                        "watermark json so `test` extracts at the same tier.")


def cmd_watermark(args) -> int:
    import jax
    import jax.numpy as jnp

    from . import embed, extract, generate_normal, similarity

    image_path = Path(args.file)
    try:
        orig = image_io.load_rgb_u8(image_path)
    except Exception as e:
        print(f"Could not load image at {image_path}: {e}", file=sys.stderr)
        return 1

    # Name wrangling: /tmp/foo.jpg -> /tmp/foo_wm.png + /tmp/foo_wm.json
    # (reference: examples/main.rs:245-251).
    image_out = image_path.with_name(image_path.stem + "_wm").with_suffix(".png")
    json_out = image_out.with_suffix(".json")
    for p in (image_out, json_out):  # no-overwrite guards (main.rs:253-265)
        if p.exists():
            print(f"{p} file already exists", file=sys.stderr)
            return 1

    method = _METHOD_CHOICES[args.method]
    ordering = _ORDERING_CHOICES[args.ordering]
    precision = _PRECISION_CHOICES[args.precision]
    ie = InsertExtract(alpha=args.alpha, method=method)
    wcfg = WriteConfig(insertion=ie, ordering=ordering, precision=precision)

    if args.seed is not None:
        key = jax.random.PRNGKey(args.seed)
    else:
        key = jax.random.PRNGKey(int.from_bytes(os.urandom(4), "little"))
    mark = np.asarray(generate_normal(key, args.length))

    marked = np.asarray(embed(jnp.asarray(orig), jnp.asarray(mark), wcfg))
    image_io.save_rgb(image_out, marked)

    st = storage.WatermarkStorage(
        config=storage.Configuration(insert_extract=ie, ordering=ordering),
        watermarks=[storage.DescribedWatermark(
            values=[float(v) for v in mark],
            description=args.description or "")],
        # Record non-default tiers so `test` extracts at the embedding tier;
        # HIGHEST stays implicit, keeping the file identical to the
        # reference's schema (examples/main.rs:110-131).
        precision=precision if precision is not Precision.HIGHEST else None,
    )
    storage.save_watermark_file(json_out, st)

    if args.print_similarity:
        rcfg = ReadConfig(extraction=ie, ordering=ordering,
                          precision=precision)
        ext = np.asarray(extract(jnp.asarray(orig),
                                 jnp.asarray(image_io.load_rgb_u8(image_out)),
                                 args.length, rcfg))
        sim = float(np.asarray(similarity(jnp.asarray(ext),
                                          jnp.asarray(mark[None])))[0])
        print(f"sim: Similarity {{ similarity: {sim} }}")
        print(f"exceeds 6 sigma: {str(sim > 6.0).lower()}")
    return 0


def _jsonl_writer(path):
    """Open a JSONL sink: '-' for stdout, a path for append, None for no-op."""
    if path is None:
        return None
    if path == "-":
        return sys.stdout
    return open(path, "a", encoding="utf-8")


def _resolve_tier(st, args):
    """Extraction tier + ranking generation for a stored watermark file:
    the file's recorded values unless overridden by --precision /
    --rank-version. ONE definition shared by ``test`` and ``detect`` so the
    two subcommands can never diverge on which tier they extract at for the
    same file."""
    prec = (_PRECISION_CHOICES[args.precision] if args.precision is not None
            else st.precision or Precision.HIGHEST)
    rank_version = (args.rank_version if args.rank_version is not None
                    else st.rank_version)
    return prec, rank_version


def _extraction_groups(loaded, args):
    """Group (path, mark) pairs by full extraction key
    (config, tier, generation, length) -- one cached extraction / base
    reader serves each group."""
    groups: dict = {}
    for path, st in loaded:
        prec, rank_version = _resolve_tier(st, args)
        for mark in st.watermarks:
            key = (st.config, prec, rank_version, len(mark.values))
            groups.setdefault(key, []).append((path, mark))
    return groups


def cmd_test(args) -> int:
    import jax.numpy as jnp

    from . import extract, similarity

    base = image_io.load_rgb_u8(args.base)
    watermarked = image_io.load_rgb_u8(args.watermarked)
    jsonl = _jsonl_writer(args.jsonl)

    loaded = [(path, storage.load_watermark_file(path))
              for path in args.watermark_files]

    # Extraction cache keyed on (config, length): one extraction serves any
    # number of candidate marks (reference: examples/main.rs:369-412).
    retrieved: dict = {}
    for path, st in loaded:
        cfg = st.config
        # Extract at the tier AND ranking generation the file records
        # (reference files record none -> HIGHEST, matching their exact rank
        # order; "Default"/"High" spellings name generation-1 fast ranking,
        # "Default2"/"High2" generation 2); --precision overrides the tier.
        prec, rank_version = _resolve_tier(st, args)
        for mark in st.watermarks:
            key = (cfg, prec, rank_version, len(mark.values))
            if key not in retrieved:
                rcfg = ReadConfig(extraction=cfg.insert_extract,
                                  ordering=cfg.ordering,
                                  precision=prec,
                                  rank_version=rank_version)
                retrieved[key] = np.asarray(extract(
                    jnp.asarray(base), jnp.asarray(watermarked),
                    len(mark.values), rcfg))
            ext = retrieved[key]
            vals = np.asarray(mark.values, dtype=np.float32)
            sim = float(np.asarray(similarity(
                jnp.asarray(ext[None]), jnp.asarray(vals[None])))[0, 0])
            # Output block format per reference examples/main.rs:418-429.
            print("-")
            print(f"  Matches: {str(sim > args.similarity_exceed).lower()}")
            print(f"  Similarity: {sim}")
            print(f"  MatchExceed: {args.similarity_exceed}")
            desc = mark.description.replace('"', '\\"')
            print(f'  Description: "{desc}"')
            print(f'  File: "{path}"')
            if jsonl is not None:
                # Structured per-mark result (SURVEY.md section 5 metrics plan).
                json.dump({
                    "base": str(args.base),
                    "watermarked": str(args.watermarked),
                    "watermark_file": str(path),
                    "description": mark.description,
                    "length": len(mark.values),
                    "similarity": sim,
                    "match_exceed": args.similarity_exceed,
                    "matches": sim > args.similarity_exceed,
                }, jsonl)
                jsonl.write("\n")
    if jsonl is not None and jsonl is not sys.stdout:
        jsonl.close()
    return 0


def cmd_detect(args) -> int:
    """Streaming detection service: one base, many derived images.

    The reference CLI's ``test`` re-derives the base reader per invocation;
    a detection service has FIXED originals and a stream of suspect images,
    so ``detect`` ranks the base once per (config, tier, generation, length)
    group -- the cached path the extract-cached benchmark measures -- and
    then processes derived images from the command
    line and/or stdin (one path per line), emitting one JSON line per
    (derived image, candidate mark). Per-image failures are isolated like
    ``batch`` (recorded, nonzero exit, stream continues).
    """
    import jax.numpy as jnp

    from . import Reader, similarity

    base = image_io.load_rgb_u8(args.base)
    loaded = [(path, storage.load_watermark_file(path))
              for path in args.watermark_files]

    # Group marks by the full extraction key so each group shares one
    # cached base reader and one similarity matmul per derived image
    # (tier resolution shared with cmd_test via _extraction_groups).
    groups = _extraction_groups(loaded, args)

    readers = {}
    for (cfg, prec, rank_version, length), marks in groups.items():
        rcfg = ReadConfig(extraction=cfg.insert_extract, ordering=cfg.ordering,
                          precision=prec, rank_version=rank_version)
        # The mark matrix is uploaded to the device ONCE here; the streaming
        # loop below only transfers each image's length-n extraction.
        readers[(cfg, prec, rank_version, length)] = (
            Reader.base(base, rcfg),
            jnp.asarray(np.stack([np.asarray(m.values, dtype=np.float32)
                                  for _, m in marks])))

    def derived_paths():
        for p in args.derived or []:
            yield p
        if args.stdin:
            for line in sys.stdin:
                line = line.strip()
                if line:
                    yield line

    jsonl = _jsonl_writer(args.jsonl) or sys.stdout
    failures = 0
    count = 0
    t0 = time.perf_counter()
    for dpath in derived_paths():
        try:
            # The whole per-image pipeline sits inside the isolation
            # boundary: decode failures AND extract-time errors (e.g. a
            # resized suspect whose shape no longer matches the base, or a
            # mark longer than the base's pixel count) are recorded and the
            # stream continues.
            derived = Reader.derived(image_io.load_rgb_u8(dpath))
            results = []
            for key, (reader, mark_matrix) in readers.items():
                length = key[3]
                ext = reader.extract(derived, length)
                sims = np.asarray(similarity(
                    jnp.asarray(ext[None]), mark_matrix))[0]
                results.append((key, length, sims))
        except Exception as e:  # noqa: BLE001 -- isolate per-image failures
            failures += 1
            json.dump({"derived": str(dpath), "error": repr(e)}, jsonl)
            jsonl.write("\n")
            jsonl.flush()
            continue
        for key, length, sims in results:
            for (wpath, mark), sim in zip(groups[key], sims):
                sim = float(sim)
                # A derived image identical to the base extracts the zero
                # vector; sim is 0/0 there. Emit 0.0 (no watermark energy)
                # so the JSONL stays machine-parseable (strict JSON has no
                # NaN) and "matches" stays false.
                if sim != sim:
                    sim = 0.0
                json.dump({
                    "derived": str(dpath),
                    "watermark_file": str(wpath),
                    "description": mark.description,
                    "length": length,
                    "similarity": sim,
                    "match_exceed": args.similarity_exceed,
                    "matches": bool(sim > args.similarity_exceed),
                }, jsonl)
                jsonl.write("\n")
        jsonl.flush()
        count += 1
    dt = time.perf_counter() - t0
    print(f"detect: {count} images in {dt:.2f}s"
          + (f"; {failures} FAILED" if failures else ""), file=sys.stderr)
    if jsonl is not sys.stdout:
        jsonl.close()
    return 1 if failures else 0


def cmd_batch(args) -> int:
    """Embed fresh marks into every image in a directory, batched on device.

    Failure semantics (SURVEY.md section 5: re-runnable idempotent batch
    processing, replacing the reference's panic-on-error):
    a per-image decode failure is recorded (stderr + JSONL ``"error"`` line)
    and the rest of the batch proceeds; the exit code is nonzero iff anything
    failed, so a scheduler retry re-runs the job, and ``--resume`` makes the
    retry idempotent by skipping images whose outputs already exist.
    """
    import jax
    import jax.numpy as jnp

    from . import embed, generate_normal

    paths = sorted(
        p for p in Path(args.directory).iterdir()
        if p.suffix.lower() in {".png", ".jpg", ".jpeg", ".bmp"}
        and not p.stem.endswith("_wm"))
    if not paths:
        print(f"no images found in {args.directory}", file=sys.stderr)
        return 1
    out_dir = Path(args.output_dir or args.directory)
    out_dir.mkdir(parents=True, exist_ok=True)

    skipped = 0
    if args.resume:
        remaining = []
        for p in paths:
            if (out_dir / (p.stem + "_wm.png")).exists() and \
                    (out_dir / (p.stem + "_wm.json")).exists():
                skipped += 1
            else:
                remaining.append(p)
        paths = remaining

    failures = []
    loaded_paths, images = [], []
    for p in paths:
        try:
            images.append(image_io.load_rgb_u8(p))
            loaded_paths.append(p)
        except Exception as e:  # noqa: BLE001 -- isolate per-image failures
            failures.append((p, repr(e)))
            print(f"failed to decode {p}: {e}", file=sys.stderr)
    paths = loaded_paths
    ie = InsertExtract(alpha=args.alpha, method=_METHOD_CHOICES[args.method])
    wcfg = WriteConfig(insertion=ie, ordering=_ORDERING_CHOICES[args.ordering],
                       precision=_PRECISION_CHOICES[args.precision])
    # Fresh entropy when unseeded (like cmd_watermark): a fixed default seed
    # would embed identical marks on every unseeded run -- a watermark-
    # security footgun.
    seed = args.seed if args.seed is not None \
        else int.from_bytes(os.urandom(4), "little")
    key = jax.random.PRNGKey(seed)
    jsonl = _jsonl_writer(args.jsonl)

    # Group by shape so each group is one batched device program.
    by_shape: dict = {}
    for p, img in zip(paths, images):
        by_shape.setdefault(img.shape, []).append((p, img))
    t0 = time.perf_counter()
    count = 0
    for shape, items in by_shape.items():
        batch = np.stack([img for _, img in items])
        key, sub = jax.random.split(key)
        marks = np.asarray(generate_normal(sub, args.length, count=len(items)))
        marked = np.asarray(embed(jnp.asarray(batch),
                                  jnp.asarray(marks[:, None, :]), wcfg))
        for (p, _), img_out, mark in zip(items, marked, marks):
            out_img = out_dir / (p.stem + "_wm.png")
            image_io.save_rgb(out_img, img_out)
            st = storage.WatermarkStorage(
                config=storage.Configuration(
                    insert_extract=ie,
                    ordering=_ORDERING_CHOICES[args.ordering]),
                watermarks=[storage.DescribedWatermark(
                    values=[float(v) for v in mark], description=p.name)],
                precision=(wcfg.precision
                           if wcfg.precision is not Precision.HIGHEST
                           else None),
            )
            storage.save_watermark_file(out_dir / (p.stem + "_wm.json"), st)
            count += 1
            if jsonl is not None:
                json.dump({
                    "input": str(p),
                    "output_image": str(out_img),
                    "output_watermark": str(out_dir / (p.stem + "_wm.json")),
                    "shape": list(shape),
                    "length": args.length,
                    "alpha": args.alpha,
                    "method": args.method,
                    "ordering": args.ordering,
                }, jsonl)
                jsonl.write("\n")
    dt = time.perf_counter() - t0
    for p, err in failures:
        if jsonl is not None:
            json.dump({"input": str(p), "error": err}, jsonl)
            jsonl.write("\n")
    msg = f"embedded {count} images in {dt:.2f}s ({count / dt:.1f} img/s)"
    if skipped:
        msg += f"; skipped {skipped} already-watermarked (--resume)"
    if failures:
        msg += f"; {len(failures)} FAILED"
    print(msg)
    if jsonl is not None and jsonl is not sys.stdout:
        jsonl.close()
    return 1 if failures else 0


def cmd_bench(args) -> int:
    from .bench import (require_gpu, run_bench, run_cached_extract_bench,
                        run_corpus_bench, run_corpus_sharded_bench,
                        run_latency_bench, run_similarity_sweep_bench,
                        run_verified_bench)

    try:
        device = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if args.config == "throughput":
        res = run_bench(batch=args.batch, size=args.size, length=args.length,
                        iters=args.iters, profile_dir=args.profile_dir,
                        content=args.content, precision=args.precision)
    elif args.config == "latency":
        # Batch-1 single-stream latency (device-side).
        res = run_latency_bench(size=args.size, length=args.length,
                                iters=args.iters, precision=args.precision)
    elif args.config == "extract-cached":
        # Reader-cached detection service: fixed originals, streamed derived.
        res = run_cached_extract_bench(batch=args.batch, size=args.size,
                                       length=args.length, iters=args.iters,
                                       precision=args.precision)
    elif args.config == "embed-verified":
        # Fused mark-then-confirm round trip (one program).
        res = run_verified_bench(batch=args.batch, size=args.size,
                                 length=args.length, iters=args.iters,
                                 precision=args.precision)
    elif args.config == "corpus":
        # BASELINE config 4: 1024-image corpus + 10k-watermark sweep.
        res = run_corpus_bench(n_images=args.corpus_images, chunk=args.batch,
                               size=args.size, length=args.length,
                               n_marks=args.sweep_marks,
                               precision=args.precision)
    elif args.config == "corpus-sharded":
        # BASELINE config 5: corpus over a joint (data, spatial) mesh.
        res = run_corpus_sharded_bench(
            n_images=args.corpus_images, chunk=args.batch, size=args.size,
            length=args.length, precision=args.precision)
    else:  # sweep
        res = run_similarity_sweep_bench(n_extracted=args.corpus_images,
                                         n_marks=args.sweep_marks,
                                         length=args.length, iters=args.iters,
                                         precision=args.precision)
    print(json.dumps({**res, **device}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ssw-tpu",
        description="Spread-spectrum image watermarking in JAX "
                    "(Cox et al. 1997, patent US5930369 step-42 equations).")
    sub = parser.add_subparsers(dest="command")

    p_wm = sub.add_parser("watermark", help="Embed a watermark into a file.")
    p_wm.add_argument("file", help="The file to watermark.")
    _add_watermark_config_args(p_wm)
    p_wm.add_argument("--description", "-d", default=None,
                      help="Description stored in the json file.")
    p_wm.add_argument("-p", dest="print_similarity", action="store_true",
                      help="Show embedded watermark similarity.")
    p_wm.add_argument("--seed", type=int, default=None,
                      help="PRNG seed (jax.random) for reproducible marks.")

    p_test = sub.add_parser(
        "test", help="Test if any of the watermarks are present in the file.")
    p_test.add_argument("--similarity-exceed", type=float, default=6.0,
                        help="Sigma threshold considered a match (default 6).")
    p_test.add_argument("base", help="The original file.")
    p_test.add_argument("watermarked", help="The derived (watermarked) file.")
    p_test.add_argument("watermark_files", nargs="+",
                        help="The watermark files to test from (.json or legacy .wm).")
    p_test.add_argument("--jsonl", default=None,
                        help="Append one JSON line per tested mark here ('-' "
                             "for stdout).")
    _add_precision_arg(p_test, for_test=True)

    p_detect = sub.add_parser(
        "detect",
        help="Detection service: one base image ranked once, a stream of "
             "derived images tested against stored marks (JSONL out).")
    p_detect.add_argument("base", help="The original file.")
    p_detect.add_argument("watermark_files", nargs="+",
                          help="Watermark files to test (.json or legacy .wm).")
    p_detect.add_argument("--derived", nargs="*", default=None,
                          help="Derived (suspect) image paths.")
    p_detect.add_argument("--stdin", action="store_true",
                          help="Also read derived image paths from stdin, "
                               "one per line (streaming mode).")
    p_detect.add_argument("--similarity-exceed", type=float, default=6.0,
                          help="Sigma threshold considered a match (default 6).")
    p_detect.add_argument("--jsonl", default=None,
                          help="Append JSON lines here instead of stdout "
                               "(append semantics, like test/batch: a "
                               "scheduler retry adds to, not replaces, the "
                               "log).")
    _add_precision_arg(p_detect, for_test=True)

    p_batch = sub.add_parser("batch", help="Watermark a directory of images (batched).")
    p_batch.add_argument("directory")
    p_batch.add_argument("--output-dir", default=None)
    _add_watermark_config_args(p_batch)
    p_batch.add_argument("--seed", type=int, default=None)
    p_batch.add_argument("--jsonl", default=None,
                         help="Append one JSON line per embedded image here "
                              "('-' for stdout).")
    p_batch.add_argument("--resume", action="store_true",
                         help="Skip images whose _wm outputs already exist "
                              "(idempotent re-run after a failure).")

    p_bench = sub.add_parser("bench", help="Throughput benchmark.")
    p_bench.add_argument("--precision", choices=_PRECISION_CHOICES,
                         default="default",
                         help="Transform precision tier for the measured "
                              "pipelines (default: the production tier).")
    p_bench.add_argument("--batch", type=int, default=32)
    p_bench.add_argument("--size", default="1080p",
                         help="HxW (e.g. 1080x1920) or 1080p/4k/cat")
    p_bench.add_argument("--length", type=int, default=1000)
    p_bench.add_argument("--iters", type=int, default=10)
    p_bench.add_argument("--profile-dir", default=None,
                         help="Write a jax.profiler trace here (TensorBoard).")
    p_bench.add_argument("--config", default="throughput",
                         choices=["throughput", "latency", "extract-cached",
                                  "embed-verified", "corpus",
                                  "corpus-sharded", "sweep"],
                         help="throughput: steady-state embed/extract; "
                              "extract-cached: fixed originals, streamed "
                              "derived (reader cache); corpus: end-to-end "
                              "corpus + mark-database sweep; sweep: "
                              "similarity matmul only.")
    p_bench.add_argument("--corpus-images", type=int, default=1024)
    p_bench.add_argument("--sweep-marks", type=int, default=10000)
    p_bench.add_argument("--content", default="noise",
                         choices=["noise", "natural"],
                         help="Input statistics for the throughput config: "
                              "uniform noise or natural-image mosaic crops.")

    args = parser.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.command == "watermark":
        return cmd_watermark(args)
    if args.command == "test":
        return cmd_test(args)
    if args.command == "detect":
        return cmd_detect(args)
    if args.command == "batch":
        return cmd_batch(args)
    if args.command == "bench":
        return cmd_bench(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
