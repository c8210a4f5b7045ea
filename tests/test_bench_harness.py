"""Bench-harness coverage at CPU-friendly scale.

BASELINE.json config 4 ("batched embed+extract of 1024 1080p images,
10k-watermark similarity sweep") is exercised here through the same harness
functions the GPU runs use (``run_corpus_bench`` /
``run_similarity_sweep_bench``), shrunk to test size. The entry points that
report numbers refuse every backend but a GPU, which the last tests check.
"""

import numpy as np
import pytest

from spread_spectrum_watermarking_tpu.bench import (
    parse_size,
    run_bench,
    run_corpus_bench,
    run_similarity_sweep_bench,
)


def test_parse_size():
    assert parse_size("1080p") == (1080, 1920)
    assert parse_size("4k") == (2160, 3840)
    assert parse_size("444x640") == (444, 640)


def test_corpus_bench_detects_own_marks():
    res = run_corpus_bench(n_images=8, chunk=4, size="cat", length=200,
                           precision="high", n_marks=64)
    # Every image's own mark must be the top-1 hit in the 64-mark sweep and
    # well above the noise floor (sim is sigma-distributed under the null).
    assert res["detection_rate_top1"] == 1.0
    assert res["min_own_mark_sigma"] > 6.0
    assert res["n_images"] == 8
    assert res["corpus_images_per_sec"] > 0


def test_similarity_sweep_bench_runs():
    res = run_similarity_sweep_bench(n_extracted=16, n_marks=128, length=200,
                                     iters=3)
    assert res["similarity_pairs_per_sec"] > 0


def test_run_bench_smoke():
    res = run_bench(batch=2, size="64x96", length=50, iters=2,
                    precision="high")
    assert res["embed_extract_images_per_sec"] > 0
    assert np.isfinite(res["embed_ms_per_image"])


def test_latency_bench_smoke():
    from spread_spectrum_watermarking_tpu.bench import run_latency_bench

    res = run_latency_bench(size="64x96", length=50, iters=2)
    assert res["embed_latency_ms"] > 0
    assert res["extract_latency_ms"] > 0
    assert res["precision"] == "default"


def test_require_gpu_refuses_cpu():
    from spread_spectrum_watermarking_tpu.bench import device_info, require_gpu

    assert device_info()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="only on a GPU"):
        require_gpu()


def test_cli_bench_refuses_cpu(capsys):
    from spread_spectrum_watermarking_tpu import cli

    assert cli.main(["bench", "--size", "64x96", "--batch", "2"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "only on a GPU" in captured.err


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_point_refuses_cpu(script):
    # Run as a user would, with only the CPU backend: a non-zero exit and
    # no figure and no result line on stdout.
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(root / script)], cwd=root,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0, res.stdout
    assert '"value"' not in res.stdout and '"ok"' not in res.stdout, res.stdout
    assert "GPU" in res.stderr, res.stderr
