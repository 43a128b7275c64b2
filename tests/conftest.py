import os
import sys

# Tests run on the CPU backend with 8 virtual devices so the
# multi-card sharding paths compile and execute without a card
# (JAX_PLATFORMS=cuda selects the card for the `gpu`-marked tests).  The
# compile cache follows JAX_COMPILATION_CACHE_DIR, else the checkout's
# own directory (bwamem_tpu/ops/fm.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="session")
def data_dir():
    return DATA_DIR


@pytest.fixture(scope="session")
def ref_index(data_dir):
    """Reference-built index artifacts loaded once per session."""
    from bwamem_tpu.index import load_index
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    return fm, bns

# smaller fixed lane count for tests: full-width (512) kernels take
# minutes of XLA CPU compile on first run; shapes stay fixed so the
# one-compile-per-kernel property is preserved
os.environ.setdefault("BWAMEM_TPU_LANES", "64")
os.environ.setdefault("BWAMEM_TPU_WAVE", "64")
os.environ.setdefault("BWAMEM_TPU_SA_SLICE", "4096")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other backends "
        "(chip_smoke.py runs these paths on the card)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import or collection)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (backend is %s)" % jax.default_backend())
