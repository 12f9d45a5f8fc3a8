import os

# Tests run on CPU with a virtual 8-device mesh (both set before jax is
# first imported). Tests marked `gpu` need the card and skip elsewhere; on a
# GPU machine run them with `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

DATA_DIR = "/root/reference/test/data"


@pytest.fixture(scope="session")
def data_dir():
    if not os.path.isdir(DATA_DIR):
        pytest.skip("reference test data not available")
    return DATA_DIR


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX finds none (decided here,
    never at import time, so every worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return jax.devices()[0]
