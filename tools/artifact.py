"""Where the measuring scripts write their JSON records: `<repo>/bench_out/`
(listed in .gitignore; the records are products of a run, not sources)."""

from __future__ import annotations

import os


def artifact_path(prefix: str) -> str:
    """e.g. artifact_path('CONFIG3') -> '<repo>/bench_out/CONFIG3.json'."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = os.path.join(repo, "bench_out")
    os.makedirs(out, exist_ok=True)
    return os.path.join(out, f"{prefix}.json")
