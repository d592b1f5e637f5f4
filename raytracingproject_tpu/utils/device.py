"""What the measuring scripts need to know about the accelerator.

Every timing this repository reports comes from a GPU. A script that times
anything calls `require_gpu` first and stops when JAX finds no GPU, rather
than timing the CPU under a device's name.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of the default devices; raises
    RuntimeError unless they are GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {devs[0].platform!r} "
            f"({devs[0].device_kind}); this script measures the GPU only"
        )
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card. Raises if nvidia-smi fails."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def print_device_header() -> dict:
    """require_gpu(), then print the device and the cards' name and power
    limit. Returns the device dict."""
    dev = require_gpu()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    print(f"nvidia-smi: {gpu_name_and_power()}", flush=True)
    return dev
