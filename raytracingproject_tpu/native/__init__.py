"""Native (C++) runtime components, loaded via ctypes.

The reference's entire runtime is C++ (SURVEY.md §2); the device compute
path here is JAX/XLA/Pallas, and the host-side runtime pieces that benefit from
native code live in this package:
- bvh_builder.cpp: binned-SAH BVH build (completes src/bvh.h:12-14).
- ppm_io.cpp: fast P3 PPM encode (the reference writes PPM from C++,
  src/color.h:14-35 + src/camera.h:35).

Libraries auto-compile on first use when g++ is available; every caller has
a pure-Python fallback, so the framework degrades gracefully without a
toolchain.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path

log = logging.getLogger("raytracingproject_tpu.native")

_DIR = Path(__file__).parent
_BUILD = _DIR / "build"
_libs: dict[str, ctypes.CDLL | None] = {}


def _compile(src: Path, out: Path) -> bool:
    _BUILD.mkdir(exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(out), str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native compile failed to launch: %s", e)
        return False
    if res.returncode != 0:
        log.warning("native compile failed:\n%s", res.stderr)
        return False
    return True


def load_library(name: str) -> ctypes.CDLL | None:
    """Load (compiling if needed) lib<name>.so; None if unavailable."""
    if name in _libs:
        return _libs[name]
    so = _BUILD / f"lib{name}.so"
    src = _DIR / f"{name}.cpp"
    lib = None
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        if not _compile(src, so):
            _libs[name] = None
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        log.warning("failed to load %s: %s", so, e)
    _libs[name] = lib
    return lib
