"""pw.io — connectors — port of pathway_tpu/io/__init__.py, trimmed to the
served path, the file connectors and Kafka: ``python`` (ConnectorSubject
sources), ``http`` (the REST connector and its webserver), ``subscribe``,
``fs`` (plaintext, plaintext_by_file, binary, csv, dsv and JSON-lines
files, static or streaming, with metadata) and its wrappers ``csv``,
``plaintext`` and ``jsonlines``, and ``kafka`` (read and write on the
port's own wire-protocol client). The other connectors of the JAX package
(databases, CDC, cloud stores) and parquet are not ported."""

from __future__ import annotations

from pathway_tpu_torch.io import (csv, fs, http, jsonlines, kafka,  # noqa: F401
                                  plaintext, python)
from pathway_tpu_torch.io._subscribe import subscribe  # noqa: F401
from pathway_tpu_torch.io.python import ConnectorSubject  # noqa: F401

__all__ = ["csv", "fs", "http", "jsonlines", "kafka", "plaintext",
           "python", "subscribe", "ConnectorSubject"]
