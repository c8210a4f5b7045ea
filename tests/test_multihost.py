"""True multi-process (DCN-path) test of multihost_initialize + collectives.

The reference has no distribution at all (SURVEY.md section 2.1); our
multi-host story is ``parallel.mesh.multihost_initialize`` (a
``jax.distributed.initialize`` wrapper) + global meshes whose collectives
ride ICI within a process and DCN across processes. A single-process
8-virtual-device mesh (tests/test_sharded.py) cannot exercise the
cross-process runtime, so this test launches TWO actual processes, each with
4 virtual CPU devices, initializes the distributed runtime over a local
coordinator, builds the global (1, 8) spatial mesh, and runs the exact
distributed top-k on a globally sharded coefficient plane -- asserting
bit-equality with the single-device oracle on every process.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys

import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
coord = sys.argv[2]

from spread_spectrum_watermarking_tpu.parallel import mesh as mesh_lib

try:
    mesh_lib.multihost_initialize(
        coordinator_address=coord, num_processes=2, process_id=pid)
except Exception as e:  # runtime service unavailable in this sandbox
    print("DISTRIBUTED-UNAVAILABLE:", e)
    sys.exit(17)

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

import spread_spectrum_watermarking_tpu as wm
from spread_spectrum_watermarking_tpu.parallel import topk_sharded

devices = jax.devices()
assert len(devices) == 8, devices
assert jax.process_count() == 2

mesh = mesh_lib.make_mesh((1, 8))
h, w, n = 64, 256, 50

rng = np.random.default_rng(42)  # same seed on both processes
plane = rng.normal(size=(h, w)).astype(np.float32)

sharding = NamedSharding(mesh, P(None, mesh_lib.SPATIAL_AXIS))
garr = jax.make_array_from_callback((h, w), sharding, lambda idx: plane[idx])

fn = shard_map(
    lambda blk: topk_sharded.distributed_top_indices(
        blk, n, wm.Ordering.ENERGY, h, w),
    mesh=mesh,
    in_specs=P(None, mesh_lib.SPATIAL_AXIS),
    out_specs=P(),
)
got = np.asarray(jax.jit(fn)(garr))

# single-device oracle (exact, reference tie order)
oracle = np.asarray(wm.ops.ranking.top_indices(
    jnp.asarray(plane)[None], n, wm.Ordering.ENERGY))[0]
assert np.array_equal(got, oracle), (got[:10], oracle[:10])

# a cross-process psum smoke check: every device contributes its process id
local = jnp.full((1,), float(jax.process_index()))
summed = float(jax.jit(
    shard_map(lambda x: jax.lax.psum(x, mesh_lib.SPATIAL_AXIS),
              mesh=mesh, in_specs=P(mesh_lib.SPATIAL_AXIS), out_specs=P()),
)(jax.make_array_from_callback(
    (8,), NamedSharding(mesh, P(mesh_lib.SPATIAL_AXIS)),
    lambda idx: np.full((1,), float(jax.process_index()), np.float32)))[0])
assert summed == 4.0, summed  # 4 devices on process 0 (0.0) + 4 on 1 (1.0)

print(f"MULTIHOST-OK pid={pid}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_multihost_distributed_topk(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    # The worker script lives in tmp_path, so sys.path[0] is not the repo;
    # make the package importable whether or not it is pip-installed.
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd="/root/repo", text=True)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))

    _skip_or_fail_if_unavailable(outs)
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{out}"
        assert f"MULTIHOST-OK pid={pid}" in out, out


def _skip_or_fail_if_unavailable(outs):
    """Loud-skip guard: in environments where the
    distributed runtime is known to work -- the repo harness exports
    SSW_REQUIRE_MULTIHOST=1 in conftest.py -- an unavailable runtime is a
    FAILURE, not a silent skip that demotes the only cross-process coverage.
    Unset/empty the variable to restore the skip in genuinely restricted
    sandboxes."""
    if any(rc == 17 for rc, _ in outs):
        detail = outs[0][1].splitlines()[-1]
        if os.environ.get("SSW_REQUIRE_MULTIHOST"):
            pytest.fail("jax distributed runtime unavailable but "
                        "SSW_REQUIRE_MULTIHOST is set: " + detail)
        pytest.skip("jax distributed runtime unavailable in this sandbox: "
                    + detail)


_CORPUS_WORKER = r"""
import sys

import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
coord = sys.argv[2]

from spread_spectrum_watermarking_tpu.parallel import mesh as mesh_lib

try:
    mesh_lib.multihost_initialize(
        coordinator_address=coord, num_processes=2, process_id=pid)
except Exception as e:  # runtime service unavailable in this sandbox
    print("DISTRIBUTED-UNAVAILABLE:", e)
    sys.exit(17)

import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils

import spread_spectrum_watermarking_tpu as wm
from spread_spectrum_watermarking_tpu.parallel import pipeline_sharded
from spread_spectrum_watermarking_tpu.utils import image_io

assert jax.process_count() == 2 and len(jax.devices()) == 8

# Joint DP x TP mesh across a REAL process boundary: data axis rows land one
# per process (devices 0-3 / 4-7), so the corpus batch is split over DCN and
# each image's rows over the process-local 'ICI' analog; the all-to-all in
# the sharded DCT stays intra-process, the top-k psums cross DCN.
mesh = mesh_lib.make_mesh((2, 4))

cat = image_io.load_rgb_u8(
    "/root/reference/tests/porcelain_cat_grey_background.jpg")
crops = np.stack([cat[oy:oy + 200, ox:ox + 160]
                  for oy, ox in [(0, 0), (40, 64), (80, 128), (120, 192)]])
n = 300
marks = np.asarray(wm.generate_normal(jax.random.PRNGKey(7), n, count=4))

marked_pad = pipeline_sharded.embed_corpus(
    jnp.asarray(crops), jnp.asarray(marks), mesh)
ext = pipeline_sharded.extract_corpus(
    jnp.asarray(crops), marked_pad, n, mesh, height=200)

# Globalize the sharded outputs (allgather over DCN) for host-side checks.
marked = np.asarray(multihost_utils.process_allgather(
    marked_pad, tiled=True))[:, :200]
ext_g = np.asarray(multihost_utils.process_allgather(ext, tiled=True))

# End-to-end detection across the process boundary.
sims = ext_g @ marks.T / np.sqrt((ext_g * ext_g).sum(-1, keepdims=True))
own = np.diag(sims)
cross = sims[~np.eye(4, dtype=bool)]
assert (own > 15.0).all(), own
assert (np.abs(cross) < 4.0).all(), cross

# Agreement with the single-process, single-device pipeline on this host.
want = np.asarray(wm.embed(jnp.asarray(crops), jnp.asarray(marks[:, None, :])))
diff = np.abs(want.astype(int) - marked.astype(int))
assert (diff > 1).mean() == 0.0, diff.max()
assert (diff > 0).mean() < 0.10, (diff > 0).mean()
ext_single = np.asarray(wm.extract(jnp.asarray(crops), jnp.asarray(marked), n))
agree = np.abs(ext_g - ext_single) < 5e-2
assert agree.mean() > 0.99, agree.mean()

# --- TP across the process boundary: a (1, 8) mesh puts one image's rows
# on all 8 devices of BOTH processes, so the sharded DCT's all-to-all and
# the distributed top-k's psums ride DCN. Must agree with the single-device
# pipeline to quantization-boundary tolerance.
tp_mesh = mesh_lib.make_mesh((1, 8))
img = cat[:256, :320]
tp_mark = np.asarray(wm.generate_normal(jax.random.PRNGKey(13), n))
marked_tp = pipeline_sharded.embed_spatial(img, jnp.asarray(tp_mark), tp_mesh)
marked_tp = np.asarray(multihost_utils.process_allgather(marked_tp, tiled=True))
want_tp = np.asarray(wm.embed(jnp.asarray(img), jnp.asarray(tp_mark)))
dtp = np.abs(want_tp.astype(int) - marked_tp.astype(int))
assert dtp.max() <= 1 and (dtp > 0).mean() < 0.10, (dtp.max(), (dtp > 0).mean())
ext_tp = pipeline_sharded.extract_spatial(img, marked_tp, n, tp_mesh)
ext_tp = np.asarray(multihost_utils.process_allgather(ext_tp, tiled=True)).reshape(-1)
sim_tp = float(ext_tp @ tp_mark / np.sqrt(ext_tp @ ext_tp))
assert sim_tp > 15.0, sim_tp

print(f"MULTIHOST-CORPUS-OK pid={pid} own={own.min():.2f} tp={sim_tp:.2f}")
"""


def test_multihost_corpus_end_to_end(tmp_path):
    """BASELINE north star "N>=2 hosts", end to end: embed_corpus /
    extract_corpus (the DP x TP pipelines of BASELINE config 5) over a
    2-process x 4-device global mesh with the batch split ACROSS the process
    boundary, asserting detection and agreement with the single-process
    pipeline. Round 3 only ran the distributed top-k across processes."""
    worker = tmp_path / "corpus_worker.py"
    worker.write_text(_CORPUS_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd="/root/repo", text=True)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))

    _skip_or_fail_if_unavailable(outs)
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{out}"
        assert f"MULTIHOST-CORPUS-OK pid={pid}" in out, out
