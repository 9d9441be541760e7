"""pw.io — connectors — port of pathway_tpu/io/__init__.py, trimmed to
the served path: ``python`` (ConnectorSubject sources), ``http`` (the
REST connector and its webserver) and ``subscribe``. The other
connectors of the JAX package (files, Kafka, databases, cloud stores)
are not ported."""

from __future__ import annotations

from pathway_tpu_torch.io import http, python  # noqa: F401
from pathway_tpu_torch.io._subscribe import subscribe  # noqa: F401
from pathway_tpu_torch.io.python import ConnectorSubject  # noqa: F401

__all__ = ["http", "python", "subscribe", "ConnectorSubject"]
