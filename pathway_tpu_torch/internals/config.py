"""Runtime config from PATHWAY_* env vars — the part of
pathway_tpu/internals/config.py the port reads."""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class PathwayConfig:
    """The worker topology the runtimes read from the environment:
    ``PATHWAY_THREADS`` (in-process sharded workers, default 1),
    ``PATHWAY_PROCESSES`` and ``PATHWAY_PROCESS_ID`` (the multi-process
    cluster, which the port refuses: ROADMAP queue 1, item 6f)."""

    @property
    def threads(self) -> int:
        return _env_int("PATHWAY_THREADS", 1)

    @property
    def processes(self) -> int:
        return _env_int("PATHWAY_PROCESSES", 1)

    @property
    def process_id(self) -> int:
        return _env_int("PATHWAY_PROCESS_ID", 0)


pathway_config = PathwayConfig()


def get_pathway_config() -> PathwayConfig:
    return pathway_config
