"""``chip_smoke.py``'s phases and gates, at small sizes on the CPU.

The phases run here on the CPU backend with small images: what they compare
and the gates they apply are the ones the card runs at full width. The one
test that needs the card runs the script itself.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from spread_spectrum_watermarking_tpu import smoke
from spread_spectrum_watermarking_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]
SMALL = (64, 96)


def test_compile_cache_env_set_leaves_jax_value(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_unset_uses_fixed_checkout_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert Path(got) == ROOT / ".jax_cache"
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in ignored


def test_compile_cache_outside_a_checkout_leaves_jax_value(monkeypatch,
                                                           tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setattr(compile_cache, "CHECKOUT", tmp_path)
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_parity_phase_matches_oracle_on_cpu():
    st = smoke.parity_phase("cpu", size=SMALL, batch=2, n=100)
    assert min(st["order_match"]) == 1.0
    assert max(st["u8_max"]) <= smoke.ORACLE_U8_MAX


def test_check_oracle_rejects_each_bound():
    good = {"u8_max": [0], "u8_frac": [0.0], "err_max": [0.1],
            "oracle_err_max": [0.1], "mean_err_diff": [0.0], "sim": [31.0],
            "oracle_sim": [31.0], "order_match": [1.0], "same_set": [True]}
    smoke.check_oracle(good)
    for key, bad in (("u8_max", 2), ("u8_frac", 0.01), ("err_max", 0.2),
                     ("mean_err_diff", 0.003), ("sim", 30.7),
                     ("order_match", 0.98), ("same_set", False)):
        with pytest.raises(AssertionError):
            smoke.check_oracle(dict(good, **{key: [bad]}))


def test_paired_and_detection_gates():
    rng = np.random.default_rng(0)
    marks = rng.standard_normal((8, 100))
    exact = marks + 0.05 * rng.standard_normal((8, 100))
    st = smoke.paired_stats(exact + 1e-3, exact, marks)
    smoke.check_paired(st)
    with pytest.raises(AssertionError):
        smoke.check_paired(smoke.paired_stats(
            exact + 0.5 * rng.standard_normal((8, 100)), exact, marks))
    own = smoke.own_sims(exact, marks)
    smoke.check_detection(own, [0.5, -1.0], 3.0, own_min=9.0)
    with pytest.raises(AssertionError):
        smoke.check_detection(own, [3.5], 3.0, own_min=9.0)


def test_tiers_phase_on_cpu():
    out = smoke.tiers_phase("cpu", size=(128, 160), batch=3, n=200)
    assert set(out) == {"default", "high"}


def test_headline_phase_on_cpu():
    out = smoke.headline_phase("cpu", size=SMALL, batch=3, size_4k=(72, 100),
                               batch_4k=2, n=100, own_min=6.0)
    assert len(out) == 4
    assert all(v.min() > 6.0 for v in out.values())


def test_rank_phases_on_cpu(tmp_path):
    path = str(tmp_path / "idx.npy")
    out = smoke.rank_write_phase("cpu", path, size=SMALL, batch=2, n=100)
    assert out["program"] == 1.0 and out["cpu"] == 1.0
    assert smoke.rank_check_phase("cpu", path, size=SMALL, batch=2,
                                  n=100) == 1.0


def test_sweep_phase_on_cpu():
    out = smoke.sweep_phase("cpu", n_ext=16, n_marks=64, n=100)
    assert out["highest"] < smoke.SWEEP_MAX_ERR


def test_four_cards_phase_on_four_virtual_devices():
    out = smoke.four_cards_phase(
        "cpu", devices=jax.devices()[:4], dp_size=SMALL, dp_batch=8,
        tp_sizes=(SMALL, (72, 100)), corpus_size=SMALL, corpus_batch=4, n=100,
        own_min=6.0)
    assert set(out) == {"dp", "tp 64x96", "tp 72x100", "dp x tp"}
    for st in out.values():
        assert len(st["device_set"]) == 4
        assert st["agreement"] > 0.99


def test_check_sharded_rejects_a_single_device_output():
    one = jax.device_put(np.zeros(4), jax.devices()[0])
    st = {"u8_max": 0, "dsim_max": 0.0, "sim_min": 31.0}
    with pytest.raises(AssertionError):
        smoke.check_sharded(st, [one], 4)


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(nvidia_gpu):
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=dict(os.environ), capture_output=True,
                         text=True, timeout=1300)
    assert res.returncode == 0, res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
