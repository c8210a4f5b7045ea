#!/usr/bin/env python
"""Run the watermarking path on the GPU and check it against its references.

    python chip_smoke.py               # every one-card phase, on one GPU
    python chip_smoke.py --four-cards  # the sharded paths, on four GPUs

This process never imports JAX. It runs each phase of
``spread_spectrum_watermarking_tpu/smoke.py`` as a child process of its
own, one after the other, so one process at a time holds the card and the
children share the persistent compilation cache. Every phase asserts; the
first that fails ends the run with a non-zero exit and no result line. The
last line of a run that passed is one JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "spread_spectrum_watermarking_tpu"
DEADLINE_S = 1150.0


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class Runner:
    def __init__(self):
        self.t0 = time.monotonic()
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)

    def run(self, name, argv, capture=False, env=None):
        """Run one child to its end; fail the whole run if it fails."""
        left = DEADLINE_S - (time.monotonic() - self.t0)
        if left <= 0:
            fail(f"out of time before {name}")
        t = time.monotonic()
        try:
            res = subprocess.run([sys.executable, *argv], cwd=ROOT,
                                 env=env or self.env, timeout=left,
                                 capture_output=capture, text=True)
        except subprocess.TimeoutExpired:
            fail(f"{name} ran past the time limit")
        if capture:
            sys.stdout.write(res.stdout)
            sys.stderr.write(res.stderr[-4000:])
            sys.stdout.flush()
        if res.returncode != 0:
            fail(f"{name} failed with exit code {res.returncode}")
        print(f"[{name}] process wall {time.monotonic() - t:.1f} s",
              flush=True)
        return res.stdout

    def phase(self, name, card, *extra, env=None, capture=False):
        return self.run(name, ["-m", f"{PACKAGE}.smoke", name, "--card", card,
                               *extra], capture=capture, env=env)


def card_name() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi failed: {e}")
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0].strip()


def cli_phase(r: Runner, card: str, tmp: Path, own_min: float) -> None:
    """``batch`` over generated PNGs, then ``test`` on two outputs, each a
    process of its own, as a user runs them; each own-mark sim must exceed
    ``own_min`` sigma."""
    src, out = tmp / "cli_in", tmp / "cli_out"
    src.mkdir()
    r.phase("cli-inputs", card, "--path", str(src))
    cli = ["-m", f"{PACKAGE}.cli"]
    r.run("cli-batch", [*cli, "batch", str(src), "--output-dir", str(out),
                        "--seed", "0", "--precision", "default"])
    for i in (0, 7):
        text = r.run("cli-test", [*cli, "test", str(src / f"img{i}.png"),
                                  str(out / f"img{i}_wm.png"),
                                  str(out / f"img{i}_wm.json")], capture=True)
        sims = [float(line.split(":", 1)[1]) for line in text.splitlines()
                if line.strip().startswith("Similarity:")]
        if len(sims) != 1 or "Matches: true" not in text or sims[0] < own_min:
            fail(f"cli test on img{i}: {sims} (want one match above "
                 f"{own_min})")
        print(f"[cli] test img{i}: sim {sims[0]!r} (bound > {own_min})",
              flush=True)


def main(argv) -> int:
    four = "--four-cards" in argv
    if set(argv) - {"--four-cards"}:
        fail(f"unknown arguments {argv}; usage: chip_smoke.py [--four-cards]")
    if not (ROOT / PACKAGE / "smoke.py").is_file():
        fail(f"{PACKAGE}/ is not beside {Path(__file__).name}")
    r = Runner()
    out = r.run("device", ["-m", f"{PACKAGE}.smoke", "device"], capture=True)
    device = json.loads(out.strip().splitlines()[-1])
    card = card_name()
    print(f"card: {card}", flush=True)
    if four:
        if device["device_count"] < 4:
            fail(f"--four-cards needs 4 GPUs, found {device['device_count']}")
        r.phase("four-cards", card)
    else:
        r.phase("parity", card)
        r.phase("tiers", card)
        r.phase("headline", card)
        with tempfile.TemporaryDirectory() as tmp:
            # Both rank children compile afresh, as two machines would.
            fresh = dict(r.env, JAX_ENABLE_COMPILATION_CACHE="false")
            plats = fresh.get("JAX_PLATFORMS")
            if plats and "cpu" not in plats.split(","):
                fresh["JAX_PLATFORMS"] = plats + ",cpu"
            idx = str(Path(tmp) / "idx.npy")
            r.phase("rank-write", card, "--path", idx, env=fresh)
            r.phase("rank-check", card, "--path", idx, env=fresh)
            r.phase("sweep", card)
            cli_phase(r, card, Path(tmp), device["own_sigma_min"])
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["device_kind"],
        "count": device["device_count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
