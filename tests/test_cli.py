"""CLI tests (reference: examples/main.rs end-to-end behavior)."""

import json
import shutil

import numpy as np
import pytest

from spread_spectrum_watermarking_tpu import cli
from spread_spectrum_watermarking_tpu.utils import image_io
from tests.conftest import CAT_JPG


@pytest.fixture
def workdir(tmp_path):
    shutil.copy(CAT_JPG, tmp_path / "cat.jpg")
    return tmp_path


def test_watermark_and_test_roundtrip(workdir, capsys):
    rc = cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "11", "-p"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "sim: Similarity" in out
    assert "exceeds 6 sigma: true" in out
    assert (workdir / "cat_wm.png").exists()
    assert (workdir / "cat_wm.json").exists()

    # JSON self-describes config, reference Version1 schema.
    obj = json.loads((workdir / "cat_wm.json").read_text())
    assert obj["Version1"]["config"]["insert_extract"]["method"] == "Option2"
    assert len(obj["Version1"]["watermarks"][0]["values"]) == 1000

    rc = cli.main(["test", str(workdir / "cat.jpg"), str(workdir / "cat_wm.png"),
                   str(workdir / "cat_wm.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out
    assert "MatchExceed: 6.0" in out


def test_no_overwrite_guard(workdir, capsys):
    (workdir / "cat_wm.png").write_bytes(b"")
    rc = cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "1"])
    assert rc == 1
    assert "already exists" in capsys.readouterr().err


def test_test_subcommand_rejects_wrong_mark(workdir, capsys):
    assert cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "11"]) == 0
    capsys.readouterr()
    # Build a bogus watermark file with random values: must not match.
    obj = json.loads((workdir / "cat_wm.json").read_text())
    rng = np.random.default_rng(0)
    obj["Version1"]["watermarks"][0]["values"] = (
        rng.standard_normal(1000).astype(float).tolist())
    (workdir / "bogus.json").write_text(json.dumps(obj))
    rc = cli.main(["test", str(workdir / "cat.jpg"), str(workdir / "cat_wm.png"),
                   str(workdir / "bogus.json")])
    assert rc == 0
    assert "Matches: false" in capsys.readouterr().out


def test_legacy_wm_file(workdir, capsys):
    # Legacy .wm files route through Option2 + Legacy ordering
    # (reference: examples/main.rs:321-344,358-362). Build one by embedding
    # with that config ourselves.
    import jax.numpy as jnp

    import spread_spectrum_watermarking_tpu as wm
    from spread_spectrum_watermarking_tpu.utils import rng_compat

    cat = image_io.load_rgb_u8(workdir / "cat.jpg")
    mark = rng_compat.generate_fixed_normal_sequence(3, 1000)
    wcfg = wm.WriteConfig(ordering=wm.Ordering.LEGACY)
    marked = np.asarray(wm.embed(jnp.asarray(cat), jnp.asarray(mark), wcfg))
    image_io.save_rgb(workdir / "legacy_wm.png", marked)
    legacy = {"alpha": 0.1, "length": 1000, "version": "2013",
              "wm": [float(v) for v in mark]}
    (workdir / "old.wm").write_text(json.dumps(legacy))

    rc = cli.main(["test", str(workdir / "cat.jpg"),
                   str(workdir / "legacy_wm.png"), str(workdir / "old.wm")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out
    assert 'File: "' in out


def test_batch_subcommand(workdir, capsys):
    shutil.copy(workdir / "cat.jpg", workdir / "cat2.jpg")
    rc = cli.main(["batch", str(workdir), "--length", "500", "--seed", "0"])
    assert rc == 0
    assert (workdir / "cat_wm.png").exists()
    assert (workdir / "cat2_wm.json").exists()
    # Each image must receive a DIFFERENT mark.
    a = json.loads((workdir / "cat_wm.json").read_text())
    b = json.loads((workdir / "cat2_wm.json").read_text())
    va = a["Version1"]["watermarks"][0]["values"]
    vb = b["Version1"]["watermarks"][0]["values"]
    assert len(va) == 500 and va != vb
    # And each must test positive against its own image.
    capsys.readouterr()
    rc = cli.main(["test", str(workdir / "cat.jpg"), str(workdir / "cat_wm.png"),
                   str(workdir / "cat_wm.json")])
    assert rc == 0
    assert "Matches: true" in capsys.readouterr().out


def test_batch_unseeded_runs_use_fresh_entropy(workdir, tmp_path_factory):
    # Two unseeded batch runs must embed DIFFERENT marks (fresh entropy when
    # --seed is absent; a fixed default would be a watermark-security bug).
    out1 = tmp_path_factory.mktemp("run1")
    out2 = tmp_path_factory.mktemp("run2")
    assert cli.main(["batch", str(workdir), "--output-dir", str(out1),
                     "--length", "100"]) == 0
    assert cli.main(["batch", str(workdir), "--output-dir", str(out2),
                     "--length", "100"]) == 0
    va = json.loads((out1 / "cat_wm.json").read_text())[
        "Version1"]["watermarks"][0]["values"]
    vb = json.loads((out2 / "cat_wm.json").read_text())[
        "Version1"]["watermarks"][0]["values"]
    assert va != vb


def test_batch_and_test_jsonl_output(workdir, capsys):
    jl = workdir / "results.jsonl"
    rc = cli.main(["batch", str(workdir), "--length", "300", "--seed", "3",
                   "--jsonl", str(jl)])
    assert rc == 0
    lines = [json.loads(s) for s in jl.read_text().splitlines()]
    assert len(lines) == 1
    assert lines[0]["input"].endswith("cat.jpg")
    assert lines[0]["length"] == 300 and lines[0]["method"] == "option2"

    jl2 = workdir / "test_results.jsonl"
    capsys.readouterr()
    rc = cli.main(["test", str(workdir / "cat.jpg"),
                   str(workdir / "cat_wm.png"), str(workdir / "cat_wm.json"),
                   "--jsonl", str(jl2)])
    assert rc == 0
    rows = [json.loads(s) for s in jl2.read_text().splitlines()]
    assert len(rows) == 1
    assert rows[0]["matches"] is True and rows[0]["similarity"] > 6.0
    assert rows[0]["length"] == 300


def test_batch_failure_isolation_and_resume(workdir, capsys):
    """Re-runnable batch semantics (SURVEY.md section 5 failure handling):
    a corrupt image is recorded and skipped, the rest of the batch completes,
    the exit code flags the failure, and a --resume re-run is idempotent."""
    d = workdir / "imgs"
    d.mkdir()
    shutil.copy(CAT_JPG, d / "a.jpg")
    shutil.copy(CAT_JPG, d / "b.jpg")
    (d / "corrupt.png").write_bytes(b"not an image at all")
    jsonl = workdir / "batch.jsonl"

    rc = cli.main(["batch", str(d), "--seed", "5", "--length", "100",
                   "--jsonl", str(jsonl)])
    assert rc == 1  # something failed -> scheduler retries
    out = capsys.readouterr().out
    assert "1 FAILED" in out
    assert (d / "a_wm.png").exists() and (d / "b_wm.json").exists()
    assert not (d / "corrupt_wm.png").exists()
    lines = [json.loads(l) for l in jsonl.read_text().splitlines()]
    assert sum("error" in l for l in lines) == 1
    assert sum("output_image" in l for l in lines) == 2

    # retry with --resume: the two finished images are skipped (idempotent),
    # only the corrupt one is reattempted and fails again.
    rc = cli.main(["batch", str(d), "--seed", "5", "--length", "100",
                   "--resume"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "embedded 0 images" in out
    assert "skipped 2" in out

    # after fixing the input, --resume finishes just the missing one.
    shutil.copy(CAT_JPG, d / "corrupt.png")
    rc = cli.main(["batch", str(d), "--seed", "5", "--length", "100",
                   "--resume"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "embedded 1 images" in out
    assert (d / "corrupt_wm.png").exists()


def test_precision_flag_roundtrip(workdir, capsys):
    # The benched production path (HIGH) must be reachable from the CLI
    # too: embed at --precision high, then test at
    # the same tier -- the embedded mark must match at >6 sigma.
    rc = cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "11",
                   "--precision", "high", "-p"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "exceeds 6 sigma: true" in out
    rc = cli.main(["test", "--precision", "high", str(workdir / "cat.jpg"),
                   str(workdir / "cat_wm.png"), str(workdir / "cat_wm.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out


def test_rank_version_override_reads_unversioned_gen2_files(workdir, capsys):
    # Builds in the unversioned gather-free window (5df7152..7f3be14) ranked
    # at generation 2 but wrote the unsuffixed "Default" spelling, which now
    # maps to generation 1 (utils/storage.py MIGRATION NOTE). `test
    # --rank-version 2` must recover such marks with the exact similarity the
    # correctly-spelled file produces (ADVICE r4 medium item).
    rc = cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "21",
                   "--precision", "default"])
    assert rc == 0
    capsys.readouterr()

    def tested_sim(*extra):
        jl = workdir / "sim.jsonl"
        jl.unlink(missing_ok=True)
        rc = cli.main(["test", str(workdir / "cat.jpg"),
                       str(workdir / "cat_wm.png"),
                       str(workdir / "cat_wm.json"),
                       "--jsonl", str(jl), *extra])
        assert rc == 0
        capsys.readouterr()
        return json.loads(jl.read_text())["similarity"]

    sim_true = tested_sim()  # correctly-spelled "Default2" file
    assert sim_true > 6.0

    # Simulate the affected window: same mark, unsuffixed spelling.
    obj = json.loads((workdir / "cat_wm.json").read_text())
    assert obj["Version1"]["precision"] == "Default2"
    obj["Version1"]["precision"] = "Default"
    (workdir / "cat_wm.json").write_text(json.dumps(obj))

    # The override must reproduce the true generation-2 extraction exactly;
    # the un-overridden read runs generation-1 ranking and must differ (the
    # generations agree on only ~1/3 of rank positions).
    assert tested_sim("--rank-version", "2") == sim_true
    assert tested_sim() != sim_true


def test_stored_precision_selects_extraction_tier(workdir, capsys):
    # Fast-tier rank order is deterministic per tier but not across tiers,
    # so the embedding tier is recorded in the watermark json and `test`
    # extracts at that tier automatically (no --precision needed).
    rc = cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "12",
                   "--precision", "default"])
    assert rc == 0
    capsys.readouterr()
    obj = json.loads((workdir / "cat_wm.json").read_text())
    # "Default2" = DEFAULT tier, fast-ranking generation 2 (utils/storage.py:
    # the spelling names the (tier, generation) pair so files self-describe).
    assert obj["Version1"]["precision"] == "Default2"
    rc = cli.main(["test", str(workdir / "cat.jpg"),
                   str(workdir / "cat_wm.png"), str(workdir / "cat_wm.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out
    # HIGHEST-tier files stay byte-compatible with the reference schema:
    # no precision key at all.
    rc = cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "13"])
    assert rc == 1  # no-overwrite guard on the first run's outputs
    (workdir / "cat_wm.png").unlink()
    (workdir / "cat_wm.json").unlink()
    rc = cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "13"])
    assert rc == 0
    obj = json.loads((workdir / "cat_wm.json").read_text())
    assert "precision" not in obj["Version1"]


def test_detect_streaming_service(workdir, capsys, monkeypatch):
    # The detection-service mode: one base ranked once, derived images
    # streamed from --derived and stdin, one JSON line per (image, mark),
    # per-image failure isolation (cli.cmd_detect; the cached read path the
    # extract-cached benchmark measures).
    import io

    assert cli.main(["watermark", str(workdir / "cat.jpg"), "--seed", "31",
                     "--precision", "default"]) == 0
    (workdir / "cat2_wm.png").write_bytes((workdir / "cat_wm.png").read_bytes())
    shutil.copy(CAT_JPG, workdir / "unmarked.jpg")
    (workdir / "corrupt.png").write_bytes(b"junk")
    # a resized suspect: decodes fine but its shape no longer matches the
    # base, so the failure surfaces at EXTRACT time -- must be isolated too.
    from PIL import Image
    Image.open(workdir / "cat_wm.png").resize((320, 222)).save(
        workdir / "resized.png")
    capsys.readouterr()

    jl = workdir / "detect.jsonl"
    monkeypatch.setattr("sys.stdin",
                        io.StringIO(f"{workdir / 'unmarked.jpg'}\n"
                                    f"{workdir / 'corrupt.png'}\n"
                                    f"{workdir / 'resized.png'}\n"))
    rc = cli.main(["detect", str(workdir / "cat.jpg"),
                   str(workdir / "cat_wm.json"),
                   "--derived", str(workdir / "cat_wm.png"),
                   str(workdir / "cat2_wm.png"),
                   "--stdin", "--jsonl", str(jl)])
    assert rc == 1  # the corrupt image failed; the stream continued
    rows = [json.loads(s) for s in jl.read_text().splitlines()]
    by_derived = {}
    for r in rows:
        by_derived.setdefault(r["derived"].rsplit("/", 1)[-1], r)
    assert by_derived["cat_wm.png"]["matches"] is True
    assert by_derived["cat_wm.png"]["similarity"] > 6.0
    assert by_derived["cat2_wm.png"]["matches"] is True  # stream reuses cache
    assert by_derived["unmarked.jpg"]["matches"] is False
    assert "error" in by_derived["corrupt.png"]
    assert "error" in by_derived["resized.png"]  # extract-time isolation
    assert "coefficient length" in by_derived["resized.png"]["error"]
    assert len(rows) == 5
