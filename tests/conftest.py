"""Test harness config: the tests force the CPU backend, 8 virtual devices.

Every test runs on JAX's CPU backend (``jax.config.update("jax_platforms",
"cpu")`` below, before any backend starts), even where a GPU is present,
with ``--xla_force_host_platform_device_count=8`` so the multi-device
sharding paths (DP/TP meshes, sharded DCT all-to-all, distributed top-k) are
exercised on virtual devices -- the reference has nothing distributed to
test (SURVEY.md section 4), this is the harness it lacked.

Tests that need the card carry the ``gpu`` marker and take the
``nvidia_gpu`` fixture, which skips them where no NVIDIA GPU is visible;
they drive the card from a child process. Run them on the card with
``python -m pytest -m gpu tests/``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

# The distributed runtime works in this harness: multihost tests must FAIL,
# not skip, if it regresses (tests/test_multihost.py guard). But the JAX
# distributed runtime needs loopback TCP, which restricted sandboxes lack --
# promote skip to fail only where a loopback socket can actually bind
# (ADVICE r4: an unconditional default turns an environment limitation into
# a suite failure for other developers). Set SSW_REQUIRE_MULTIHOST=""/"1"
# explicitly to force either mode.


def _loopback_tcp_available() -> bool:
    import socket

    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
        return True
    except OSError:
        return False


if "SSW_REQUIRE_MULTIHOST" not in os.environ and _loopback_tcp_available():
    os.environ["SSW_REQUIRE_MULTIHOST"] = "1"

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"
CAT_JPG = os.path.join(REFERENCE_DIR, "tests/porcelain_cat_grey_background.jpg")
GOLDEN_PNG = os.path.join(REFERENCE_DIR, "tests/watermarked_with_1.png")


@pytest.fixture(scope="session")
def nvidia_gpu():
    """Skip unless ``nvidia-smi`` sees a GPU (decided here, never at import)."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none)")


@pytest.fixture(scope="session")
def cat_image():
    from spread_spectrum_watermarking_tpu.utils import image_io

    return image_io.load_rgb_u8(CAT_JPG)


@pytest.fixture(scope="session")
def golden_image():
    from spread_spectrum_watermarking_tpu.utils import image_io

    return image_io.load_rgb_u8(GOLDEN_PNG)
