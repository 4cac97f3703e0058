import os

# Smoke tests must see the single real CPU device — the 512-device flag is
# set ONLY by launch/dryrun.py (and benchmarks/roofline.py).  Guard against
# accidental inheritance from a dry-run shell.  Exception: the mesh-serving
# suite (test_mesh_serving.py) NEEDS a multi-device CPU, so its CI step
# opts in with REPRO_KEEP_XLA_FLAGS=1 and its own
# --xla_force_host_platform_device_count setting.
if not os.environ.get("REPRO_KEEP_XLA_FLAGS"):
    os.environ.pop("XLA_FLAGS", None)

import jax

jax.config.update("jax_enable_x64", False)


# Shard count for the slow per-arch smoke suite (test_models_smoke.py):
# CI runs `pytest tests/test_models_smoke.py -m smokeN` as a matrix
# dimension (one job per shard — keep .github/workflows/ci.yml's matrix
# list in sync with this).  test_models_smoke.py imports this constant.
N_SMOKE_SHARDS = 4


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (the port's CUDA kernels); "
        "skips inside the test when there is none")
    for i in range(N_SMOKE_SHARDS):
        config.addinivalue_line(
            "markers", f"smoke{i}: test_models_smoke CI matrix shard {i}")


def pytest_collection_modifyitems(config, items):
    # Safety net: tier-1 CI ignores test_models_smoke.py and each matrix
    # job selects one smokeN mark, so a test added there WITHOUT a shard
    # mark would never run in CI.  Assign unmarked ones deterministically.
    import zlib

    import pytest

    for item in items:
        if os.path.basename(str(item.fspath)) != "test_models_smoke.py":
            continue
        if any(m.name.startswith("smoke") for m in item.iter_markers()):
            continue
        shard = zlib.crc32(item.nodeid.encode()) % N_SMOKE_SHARDS
        item.add_marker(getattr(pytest.mark, f"smoke{shard}"))
