"""pw.io.kafka — port of pathway_tpu/io/kafka/__init__.py (reference:
python/pathway/io/kafka + KafkaReader/Writer,
src/connectors/data_storage.rs:720,2142).

Reads and writes through the port's own wire-protocol client
(``_protocol.py``: Metadata, ListOffsets, Fetch and Produce with
RecordBatch v2 and CRC32C), with partitions assigned by hand and an offset
kept a partition: one Fetch covers every partition of the topic, and a
partition whose offset fell out of range is re-resolved alone
(``auto.offset.reset``). The JAX package's ``kafka-python`` /
``confluent_kafka`` branch is left out: neither the chip machine nor the
CPU sandbox has either package, and the native client is the path both
packages take without them. So the client speaks plaintext only, and
``read_from_upstash`` (SASL over SSL) raises. Not ported, each raising
``NotImplementedError`` naming its ROADMAP item: ``persistent_id`` with
resume from offsets (queue 1, step 7, item 6a) and the connector
supervisor's restarts (item 6c).
"""

from __future__ import annotations

import functools
import json as _json
import logging

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Plan, Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._datasource import (DataSource, Session,
                                              apply_connector_policy)

_PERSISTENCE = "ROADMAP queue 1, step 7, item 6a: persistence and snapshots"
_SUPERVISOR = ("ROADMAP queue 1, step 7, item 6c: the connector supervisor "
               "and watchdog")
_TLS = "the native client speaks plaintext only"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to pathway_tpu_torch yet ({item})")


class KafkaSource(DataSource):
    name = "kafka"

    def __init__(self, rdkafka_settings: dict, topic: str, format: str,
                 schema, autocommit_duration_ms=1500):
        super().__init__(schema, autocommit_duration_ms)
        if rdkafka_settings.get("security.protocol", "plaintext").lower() \
                != "plaintext":
            raise _not_ported(
                f"security.protocol={rdkafka_settings['security.protocol']!r}"
                f" ({_TLS})", _SUPERVISOR)
        self.settings = rdkafka_settings
        self.topic = topic
        self.format = format

    def seek_offsets(self, antichain) -> None:
        """Persistence resume from a durable offset frontier."""
        raise _not_ported("resuming pw.io.kafka.read from offsets",
                          _PERSISTENCE)

    def run(self, session: Session) -> None:
        """Wire-protocol reader: partitions assigned by hand, each from its
        earliest (or latest) offset, one Fetch a poll covering them all."""
        from pathway_tpu_torch.io.kafka._protocol import (CONTROL,
                                                          KafkaClient,
                                                          KafkaProtocolError)

        log = logging.getLogger(__name__)
        hosts = [h.strip() for h in self.settings.get(
            "bootstrap.servers", "127.0.0.1:9092").split(",") if h.strip()]
        host_idx = 0
        reset = self.settings.get("auto.offset.reset", "earliest")
        seq = 0

        def emit(partition, offset, value):
            nonlocal seq
            if value is CONTROL:
                return  # transaction marker: advance the offset, emit nothing
            if self.format == "raw":
                values = {"data": value}  # a tombstone emits data=None
            elif value is None:
                return  # json-format tombstone: nothing to parse
            else:
                try:
                    values = _json.loads(value)
                except (ValueError, UnicodeDecodeError):
                    # a malformed message must not kill the reader; the
                    # offset still advances so it is consumed exactly once
                    log.warning("kafka: skipping non-JSON message at %s[%s]",
                                partition, offset)
                    return
            key, row = self.row_to_engine(values, seq)
            seq += 1
            session.push(key, row, 1, offset=("part", partition, offset))

        backoff = 1.0
        client = None
        positions: dict[int, int] = {}
        while not session.stop_requested:
            try:
                if client is None:
                    # rotate bootstrap hosts across reconnects (failover)
                    client = KafkaClient(hosts[host_idx % len(hosts)])
                    host_idx += 1
                    parts = sorted(client.metadata(self.topic))
                # resolve any partition without a position: new partitions,
                # or one reset after an out-of-range offset
                for pid in parts:
                    if pid not in positions:
                        positions[pid] = client.list_offsets(
                            self.topic, pid,
                            -2 if reset == "earliest" else -1)
                any_data = False
                # one fetch covers every partition: per-partition polling
                # would pay the broker's max_wait serially per idle one
                by_part = client.fetch_many(self.topic, dict(positions))
                for pid, records in by_part.items():
                    for offset, _key, value in records:
                        emit(pid, offset, value)
                        positions[pid] = offset + 1
                        any_data = True
                backoff = 1.0
                if not any_data and not session.sleep(0.05):
                    return
            except KafkaProtocolError as e:
                if e.code == 1:
                    # OFFSET_OUT_OF_RANGE (retention passed the position):
                    # honor auto.offset.reset for the failing partition
                    # only; the healthy ones keep their positions
                    log.warning(
                        "kafka offset out of range on partition %s; "
                        "re-resolving it via auto.offset.reset=%s",
                        e.partition, reset)
                    if e.partition is not None:
                        positions.pop(e.partition, None)
                    else:
                        positions.clear()
                    continue
                # other broker errors (leader moved, topic recreated):
                # reconnect and refresh metadata, keeping the positions
                log.warning("kafka protocol error (%s); reconnecting in "
                            "%.0fs", e, backoff)
                if client is not None:
                    client.close()
                    client = None
                if not session.sleep(backoff):
                    return
                backoff = min(backoff * 2, 30.0)
            except (ConnectionError, OSError, RuntimeError) as e:
                log.warning("kafka native reader error (%s); reconnecting "
                            "in %.0fs", e, backoff)
                if client is not None:
                    client.close()
                    client = None
                if not session.sleep(backoff):
                    return
                backoff = min(backoff * 2, 30.0)
        if client is not None:
            client.close()


def read(rdkafka_settings: dict, topic: str | None = None, *, schema=None,
         format: str = "raw", autocommit_duration_ms: int | None = 1500,
         name=None, persistent_id=None, **kwargs) -> Table:
    """A table of the topic's messages: ``format="raw"`` a ``data`` bytes
    column, ``"json"`` the schema's columns from each JSON message. The
    reader thread starts with ``pw.run`` and polls every partition."""
    if persistent_id is not None:
        raise _not_ported("pw.io.kafka.read(persistent_id=...)",
                          _PERSISTENCE)
    if schema is None:
        schema = sch.schema_from_types(data=dt.BYTES)
    source = KafkaSource(rdkafka_settings, topic, format, schema,
                         autocommit_duration_ms=autocommit_duration_ms)
    apply_connector_policy(source, kwargs)
    return Table(Plan("input", datasource=source), schema, Universe(),
                 name=name or "kafka_input")


def write(table: Table, rdkafka_settings: dict, topic_name: str, *,
          format: str = "json", name=None, **kwargs) -> None:
    """Each tick's changes of ``table`` as JSON messages (its columns plus
    ``time`` and ``diff``), produced to one partition a tick in turn, as
    a keyless producer spreads them."""
    names = table.column_names()
    bootstrap = rdkafka_settings.get("bootstrap.servers", "127.0.0.1:9092")

    def encode_rows(time, delta):
        out = []
        for _key, row, diff in delta.entries:
            rec = dict(zip(names, row))
            rec["time"] = time
            rec["diff"] = diff
            out.append(_json.dumps(rec, default=str).encode())
        return out

    def binder(runner):
        from pathway_tpu_torch.io.kafka._protocol import KafkaClient

        state = {"client": None, "next_part": 0, "parts": None}
        hosts = [h.strip() for h in bootstrap.split(",") if h.strip()]

        def send(payloads):
            if state["client"] is None:
                state["client"] = KafkaClient(
                    hosts[state["next_part"] % len(hosts)])
                state["parts"] = sorted(
                    state["client"].metadata(topic_name)) or [0]
            # round-robin partitions per tick, like a keyless producer
            parts = state["parts"]
            pid = parts[state["next_part"] % len(parts)]
            state["next_part"] += 1
            state["client"].produce(
                topic_name, pid, [(None, v) for v in payloads])

        def callback(time, delta):
            payloads = encode_rows(time, delta)
            if not payloads:
                return
            try:
                send(payloads)
            except (ConnectionError, OSError, RuntimeError):
                # broker blip: drop the dead socket and retry once so a
                # restart does not poison every later tick
                if state["client"] is not None:
                    state["client"].close()
                    state["client"] = None
                send(payloads)

        runner.subscribe(table, callback)

    G.add_output(binder, table=table, sink="kafka", format=format)


def check_raw_and_plaintext_only_kwargs(f):
    """Decorator rejecting key/value/headers kwargs outside raw/plaintext
    formats (reference: io/kafka/__init__.py:499)."""

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        if kwargs.get("format") not in ("raw", "plaintext"):
            for param in ("key", "value", "headers"):
                if kwargs.get(param) is not None:
                    raise ValueError(
                        f"Unsupported argument for "
                        f"{kwargs.get('format')} format: {param}")
        return f(*args, **kwargs)

    return wrapper


def simple_read(server: str, topic: str, *, read_only_new: bool = False,
                schema=None, format: str = "raw",
                autocommit_duration_ms: int | None = 1500,
                **kwargs) -> Table:
    """One-server reader (reference: io/kafka/__init__.py:291), from the
    earliest offsets or, with ``read_only_new``, the latest."""
    settings = {
        "bootstrap.servers": server,
        "group.id": None,
        "session.timeout.ms": "6000",
        "enable.auto.commit": "false",
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(settings, topic, schema=schema, format=format,
                autocommit_duration_ms=autocommit_duration_ms, **kwargs)


write = check_raw_and_plaintext_only_kwargs(write)  # reference guard


def read_from_upstash(endpoint: str, username: str, password: str,
                      topic: str, **kwargs) -> Table:
    """Upstash-hosted Kafka (reference: io/kafka/__init__.py:388) needs
    SASL-SCRAM over SSL, which the native client does not speak."""
    raise _not_ported(f"pw.io.kafka.read_from_upstash ({_TLS})", _SUPERVISOR)
