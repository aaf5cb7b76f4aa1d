import os
import sys

# Smoke tests and benches must see the single real CPU device; only
# launch/dryrun.py forces 512 placeholder devices (and only in its own
# process).  Guard against accidental inheritance.
os.environ.pop("XLA_FLAGS", None)

# Tier-1 unblock: several test modules import `hypothesis` at collection
# time, which is not installable in this container.  Install the
# deterministic fallback (fixed-seed @given/strategies stand-in) before any
# test module is imported; the real package wins when it is available.
# Loaded by file path: `tests` is not an importable package under every
# pytest entry point / cwd, but conftest's own directory always is known.
try:
    import hypothesis  # noqa: F401
except ImportError:
    import importlib.util

    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_fallback",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_hypothesis_fallback.py"))
    _hypothesis_fallback = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_hypothesis_fallback)
    sys.modules["hypothesis"] = _hypothesis_fallback
    sys.modules["hypothesis.strategies"] = _hypothesis_fallback.strategies

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "tpu: needs compiled Pallas kernels (a real TPU device); "
        "skipped elsewhere")
    config.addinivalue_line(
        "markers", "slow: multi-second test (subprocess gate CLI, tiny "
        "train loops); run by default, deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch/CUDA port's "
        "hand-written kernels); skipped elsewhere")


def pytest_collection_modifyitems(config, items):
    if jax.default_backend() == "tpu":
        return
    skip_tpu = pytest.mark.skip(reason="compiled Pallas path needs a TPU "
                                "device (interpret-mode twin runs instead)")
    for item in items:
        if "tpu" in item.keywords:
            item.add_marker(skip_tpu)


@pytest.fixture(autouse=True, scope="module")
def _drop_jit_caches_between_modules():
    # The suite is ~470 jit-heavy tests in one process; XLA's CPU JIT keeps
    # every compiled executable alive until the cache entry dies, and past
    # ~400 tests the accumulated code memory segfaults later compiles.
    # Modules don't share shapes enough for cross-module cache hits to
    # matter, so drop the caches at each module boundary.
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_path(rng, B, M, d, scale=0.3):
    return np.cumsum(rng.normal(size=(B, M + 1, d)) * scale, axis=1).astype(
        np.float32)
