"""The Kafka wire protocol, dependency-free — port of
pathway_tpu/io/kafka/_protocol.py: the subset a partition-assigned reader
and writer need, ApiVersions, Metadata v1, ListOffsets v1, Fetch v4 and
Produce v3, with RecordBatch v2 framing (zigzag varints, CRC32C).

It stands in for the reference's rdkafka client (KafkaReader/KafkaWriter,
src/connectors/data_storage.rs:720,2142) with the protocol itself
(https://kafka.apache.org/protocol). Consumer groups are not used:
partitions are assigned by hand and each partition's offset is tracked by
the reader. The bytes each encoder writes and the records
``parse_record_batches`` reads are the JAX package's, byte for byte.
"""

from __future__ import annotations

import socket
import struct
import time as _time
from typing import Iterator


class KafkaProtocolError(RuntimeError):
    """Broker-reported error code (OFFSET_OUT_OF_RANGE=1, NOT_LEADER=6...).

    ``partition`` carries the failing partition id when the error came from
    a per-partition response (fetch), so callers can recover just that
    partition instead of resetting every healthy one."""

    def __init__(self, code: int, context: str, partition: int | None = None):
        super().__init__(f"kafka error {code} ({context})")
        self.code = code
        self.partition = partition

# -- primitives -------------------------------------------------------------


def enc_int8(v):
    return struct.pack(">b", v)


def enc_int16(v):
    return struct.pack(">h", v)


def enc_int32(v):
    return struct.pack(">i", v)


def enc_int64(v):
    return struct.pack(">q", v)


def enc_string(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def enc_bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def enc_varint(v: int) -> bytes:
    """Zigzag varint (record framing)."""
    z = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def int8(self):
        v = struct.unpack_from(">b", self.data, self.pos)[0]
        self.pos += 1
        return v

    def int16(self):
        v = struct.unpack_from(">h", self.data, self.pos)[0]
        self.pos += 2
        return v

    def int32(self):
        v = struct.unpack_from(">i", self.data, self.pos)[0]
        self.pos += 4
        return v

    def uint32(self):
        v = struct.unpack_from(">I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def int64(self):
        v = struct.unpack_from(">q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def string(self):
        n = self.int16()
        if n < 0:
            return None
        s = self.data[self.pos:self.pos + n].decode()
        self.pos += n
        return s

    def bytes_(self):
        n = self.int32()
        if n < 0:
            return None
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def varint(self) -> int:
        z = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (z >> 1) ^ -(z & 1)

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b


# -- CRC32C (Castagnoli) — required by RecordBatch v2 -----------------------

_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


# -- RecordBatch v2 ---------------------------------------------------------


def encode_record_batch(records: list[tuple[bytes | None, bytes | None]],
                        base_offset: int = 0,
                        first_timestamp: int | None = None) -> bytes:
    """[(key, value)] -> one RecordBatch v2 blob. Timestamps default to
    now: epoch-0 stamps would make real brokers retention-delete the
    segment immediately."""
    if first_timestamp is None:
        first_timestamp = int(_time.time() * 1000)
    recs = bytearray()
    for i, (key, value) in enumerate(records):
        body = bytearray()
        body += enc_int8(0)              # attributes
        body += enc_varint(0)            # timestamp delta
        body += enc_varint(i)            # offset delta
        if key is None:
            body += enc_varint(-1)
        else:
            body += enc_varint(len(key)) + key
        if value is None:
            body += enc_varint(-1)
        else:
            body += enc_varint(len(value)) + value
        body += enc_varint(0)            # headers count
        recs += enc_varint(len(body)) + body
    # everything after the crc field participates in the crc
    tail = (
        enc_int16(0)                     # attributes (no compression)
        + enc_int32(len(records) - 1)    # lastOffsetDelta
        + enc_int64(first_timestamp)
        + enc_int64(first_timestamp)
        + enc_int64(-1)                  # producerId
        + enc_int16(-1)                  # producerEpoch
        + enc_int32(-1)                  # baseSequence
        + enc_int32(len(records))
        + bytes(recs)
    )
    crc = crc32c(tail)
    inner = enc_int32(-1) + enc_int8(2) + struct.pack(">I", crc) + tail
    #        partitionLeaderEpoch  magic
    return enc_int64(base_offset) + enc_int32(len(inner)) + inner


# distinct sentinel for control batches (transaction markers): a tombstone
# record also has key=None value=None, so (offset, None, None) would be
# ambiguous
CONTROL = object()


def parse_record_batches(data: bytes) -> Iterator[tuple[int, object,
                                                        object]]:
    """Yield (offset, key, value) from a concatenation of RecordBatch v2
    blobs (a Fetch response's record set); control batches yield one
    ``(offset, CONTROL, CONTROL)`` marker. Truncated tails are skipped —
    brokers may return partial batches at the end of a fetch."""
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        (base_offset,) = struct.unpack_from(">q", data, pos)
        (batch_len,) = struct.unpack_from(">i", data, pos + 8)
        end = pos + 12 + batch_len
        if batch_len <= 0 or end > n:
            return
        r = Reader(data, pos + 12)
        r.int32()                        # partitionLeaderEpoch
        magic = r.int8()
        if magic != 2:
            raise KafkaProtocolError(
                -1, f"record batch magic {magic} — the native client reads "
                "message format v2 only")
        r.uint32()                       # crc (trusted: TCP + broker)
        attrs = r.int16()
        if attrs & 0x20:
            # control batch (transaction markers): nothing to emit, but the
            # caller must still advance PAST it or it refetches forever —
            # yield one CONTROL marker at the batch's end
            lod = r.int32()              # lastOffsetDelta
            yield base_offset + lod, CONTROL, CONTROL
            pos = end
            continue
        if attrs & 0x07:
            # silent skipping would stall a reader at this offset forever
            raise KafkaProtocolError(
                -1, "compressed record batch — the native client reads "
                "uncompressed topics only; produce uncompressed")
        r.int32()                        # lastOffsetDelta
        r.int64()                        # firstTimestamp
        r.int64()                        # maxTimestamp
        r.int64()                        # producerId
        r.int16()                        # producerEpoch
        r.int32()                        # baseSequence
        count = r.int32()
        for _ in range(max(count, 0)):
            length = r.varint()
            rec_end = r.pos + length
            r.int8()                     # attributes
            r.varint()                   # timestamp delta
            offset_delta = r.varint()
            klen = r.varint()
            key = r.take(klen) if klen >= 0 else None
            vlen = r.varint()
            value = r.take(vlen) if vlen >= 0 else None
            r.pos = rec_end              # skip headers
            yield base_offset + offset_delta, key, value
        pos = end


# -- client -----------------------------------------------------------------

API_PRODUCE, API_FETCH, API_LIST_OFFSETS, API_METADATA = 0, 1, 2, 3
API_VERSIONS = 18


class KafkaClient:
    """One-broker-at-a-time client with manual partition assignment."""

    def __init__(self, bootstrap: str, client_id: str = "pathway-tpu",
                 timeout: float = 30.0):
        host, _, port = bootstrap.partition(":")
        self.bootstrap = (host or "127.0.0.1", int(port or 9092))
        self.client_id = client_id
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._corr = 0

    # -- transport ----------------------------------------------------------
    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.bootstrap,
                                                  timeout=self.timeout)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, api_key: int, api_version: int, body: bytes) -> Reader:
        self._corr += 1
        header = (enc_int16(api_key) + enc_int16(api_version)
                  + enc_int32(self._corr) + enc_string(self.client_id))
        frame = header + body
        sock = self._conn()
        sock.sendall(enc_int32(len(frame)) + frame)
        raw = self._read_exact(4)
        (length,) = struct.unpack(">i", raw)
        payload = self._read_exact(length)
        r = Reader(payload)
        corr = r.int32()
        if corr != self._corr:
            raise ConnectionError(
                f"kafka correlation mismatch: {corr} != {self._corr}")
        return r

    def _read_exact(self, n: int) -> bytes:
        sock = self._conn()
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("kafka connection closed")
            buf += chunk
        return buf

    # -- APIs ---------------------------------------------------------------
    def api_versions(self) -> dict[int, tuple[int, int]]:
        r = self._call(API_VERSIONS, 0, b"")
        err = r.int16()
        if err:
            raise RuntimeError(f"ApiVersions error {err}")
        out = {}
        for _ in range(r.int32()):
            k, lo, hi = r.int16(), r.int16(), r.int16()
            out[k] = (lo, hi)
        return out

    def metadata(self, topic: str) -> dict[int, int]:
        """topic -> {partition: leader broker id} (single-broker scope:
        the bootstrap connection serves all partitions)."""
        body = enc_int32(1) + enc_string(topic)
        r = self._call(API_METADATA, 1, body)
        for _ in range(r.int32()):       # brokers
            r.int32()
            r.string()
            r.int32()
            r.string()                   # rack (v1)
        r.int32()                        # controller id
        partitions: dict[int, int] = {}
        for _ in range(r.int32()):       # topics
            terr = r.int16()
            tname = r.string()
            r.int8()                     # is_internal
            n_parts = r.int32()
            for _ in range(n_parts):
                perr = r.int16()
                pid = r.int32()
                leader = r.int32()
                for _ in range(r.int32()):
                    r.int32()            # replicas
                for _ in range(r.int32()):
                    r.int32()            # isr
                if tname == topic and not perr:
                    partitions[pid] = leader
            if terr and tname == topic:
                raise KafkaProtocolError(terr, f"metadata for {topic!r}")
        return partitions

    def list_offsets(self, topic: str, partition: int,
                     timestamp: int = -2) -> int:
        """-2 = earliest, -1 = latest."""
        body = (enc_int32(-1)            # replica id
                + enc_int32(1) + enc_string(topic)
                + enc_int32(1) + enc_int32(partition) + enc_int64(timestamp))
        r = self._call(API_LIST_OFFSETS, 1, body)
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()                # partition
                err = r.int16()
                r.int64()                # timestamp
                offset = r.int64()
                if err:
                    raise KafkaProtocolError(err, "list_offsets")
                return offset
        raise RuntimeError("empty ListOffsets response")

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 500
              ) -> list[tuple[int, bytes | None, bytes | None]]:
        return self.fetch_many(topic, {partition: offset}, max_bytes,
                               max_wait_ms)[partition]

    def fetch_many(self, topic: str, offsets: dict[int, int],
                   max_bytes: int = 1 << 20, max_wait_ms: int = 500
                   ) -> dict[int, list[tuple[int, bytes | None,
                                             bytes | None]]]:
        """ONE request covering every partition — per-partition polling
        would pay max_wait_ms serially per idle partition."""
        parts = sorted(offsets)
        body = (enc_int32(-1)            # replica id
                + enc_int32(max_wait_ms) + enc_int32(1)   # min_bytes
                + enc_int32(max_bytes)   # max_bytes (v3+)
                + enc_int8(0)            # isolation level (v4+)
                + enc_int32(1) + enc_string(topic)
                + enc_int32(len(parts)))
        for pid in parts:
            body += (enc_int32(pid) + enc_int64(offsets[pid])
                     + enc_int32(max_bytes))
        r = self._call(API_FETCH, 4, body)
        r.int32()                        # throttle
        out: dict = {pid: [] for pid in parts}
        errors: dict[int, int] = {}
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                pid = r.int32()
                err = r.int16()
                r.int64()                # high watermark
                r.int64()                # last stable offset (v4)
                for _ in range(r.int32()):
                    r.int64()            # aborted txn producer id
                    r.int64()            # first offset
                records = r.bytes_()
                if err:
                    errors[pid] = err
                elif records:
                    base = offsets.get(pid, 0)
                    out[pid] = [(o, k, v)
                                for o, k, v in parse_record_batches(records)
                                if o >= base]
        if errors:
            pid, err = next(iter(errors.items()))
            raise KafkaProtocolError(err, f"fetch partition {pid}",
                                     partition=pid)
        return out

    def produce(self, topic: str, partition: int,
                records: list[tuple[bytes | None, bytes | None]],
                acks: int = -1) -> int:
        batch = encode_record_batch(records)
        body = (enc_string(None)         # transactional id (v3+)
                + enc_int16(acks) + enc_int32(30_000)
                + enc_int32(1) + enc_string(topic)
                + enc_int32(1) + enc_int32(partition) + enc_bytes(batch))
        r = self._call(API_PRODUCE, 3, body)
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()                # partition
                err = r.int16()
                base_offset = r.int64()
                r.int64()                # log append time (v2+)
                if err:
                    raise KafkaProtocolError(err, "produce")
                return base_offset
        raise RuntimeError("empty Produce response")
