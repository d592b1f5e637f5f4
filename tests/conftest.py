"""Test harness config: two lanes.

- Default lane (`RTP_BACKEND` unset or "cpu"): a virtual 8-device CPU mesh —
  the "fake backend" strategy from SURVEY.md §4 for validating multi-device
  sharding without cards (xla_force_host_platform_device_count=8). Pallas
  kernels run here only through their interpreter, asked for explicitly.
- GPU lane (`RTP_BACKEND=gpu`): JAX keeps its default backend. Tests marked
  `@pytest.mark.gpu` take the `gpu_device` fixture, which skips them unless
  JAX's default devices are GPUs; run them on a machine with a GPU with
  `RTP_BACKEND=gpu python -m pytest tests/ -m gpu`.

Forcing the CPU takes both the XLA flag in the environment (read when the
CPU client initializes) and a config update (in case something pinned
`jax_platforms` before the tests import JAX).
"""

import os

import pytest

RTP_BACKEND = os.environ.get("RTP_BACKEND", "cpu").lower()

if RTP_BACKEND == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The default JAX device, or a skip unless it is a GPU. Decided when a
    test runs, never at import, so every worker collects the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}); run "
                    "RTP_BACKEND=gpu python -m pytest tests/ -m gpu on one")
    return dev
