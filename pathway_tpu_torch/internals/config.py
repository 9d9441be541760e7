"""Runtime config from PATHWAY_* env vars — the part of
pathway_tpu/internals/config.py the port reads."""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default
