"""Test env: the CPU backend with 8 virtual devices, so multi-device sharding
paths run without accelerators (must be set before jax initializes).

Tests that need a GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them when the backend has no GPU. They run on a GPU
machine with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`; any other
JAX_PLATFORMS value than cpu leaves the platform and device count alone."""

import os
import re

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" in flags:
        # an inherited different count would break every sharding test with
        # confusing mesh-size errors — rewrite it rather than append a
        # duplicate
        flags = re.sub(r"--xla_force_host_platform_device_count=\d+",
                       "--xla_force_host_platform_device_count=8", flags)
        os.environ["XLA_FLAGS"] = flags
    else:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The CPU tests compile small programs whose persistent-cache entries are
# not worth keeping; keep test runs from reading or writing the cache.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def gpu_device():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; the backend is {devices[0].platform}")
    return devices[0]


@pytest.fixture(scope="session")
def reference_src():
    """Path of a KCL-BMEIS/VS_Seg source checkout (env VS_REFERENCE_SRC),
    with the MONAI-0.4 shim installed; skips the test without one."""
    root = os.environ.get("VS_REFERENCE_SRC", "")
    if not root or not os.path.isdir(os.path.join(root, "params")):
        pytest.skip("reference source tree not available "
                    "(set VS_REFERENCE_SRC to a VS_Seg checkout)")
    from tests.monai_shim import install_shim
    install_shim(root)
    return root


@pytest.fixture(scope="session")
def synthetic_root(tmp_path_factory):
    from vs_seg.data.synthetic import generate_dataset
    root = tmp_path_factory.mktemp("vsdata")
    generate_dataset(str(root), n_train=2, n_val=2, n_test=2, shape=(48, 48, 16))
    return str(root)
