"""The port's pw.io.kafka (pathway_tpu_torch/io/kafka/) against the JAX
package's (pathway_tpu/io/kafka/), neither with a client package installed:

- ``_protocol``'s encoders give the JAX module's bytes and
  ``parse_record_batches`` its records, CRC32C included, over
  hypothesis-drawn values and batches;
- both clients against one in-test broker (a copy of
  tests/test_kafka_native.py's, speaking ApiVersions, Metadata,
  ListOffsets, Fetch and Produce on 127.0.0.1 with the port's codecs);
- ``pw.io.kafka.write`` -> broker -> ``pw.io.kafka.read`` under ``pw.run``
  in each package, the same rows under the same keys, as
  tests/test_kafka_native.py:168-285 drives the JAX package's.
"""

from __future__ import annotations

import itertools
import json
import socket
import struct
import threading
import time
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pathway_tpu.io.kafka import _protocol as jkp
from pathway_tpu_torch.io.kafka import _protocol as kp

DEADLINE_S = 30.0


class FakeBroker:
    """Single-node broker: in-memory partition logs."""

    def __init__(self, topics: dict[str, int]):
        # topic -> [partition logs]; log = list[(key, value)]
        self.logs = {t: [[] for _ in range(n)] for t, n in topics.items()}
        self.force_error = None  # (partition, code): next fetch fails there
        self.server = socket.create_server(("127.0.0.1", 0))
        self.port = self.server.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                raw = self._read_exact(conn, 4)
                (length,) = struct.unpack(">i", raw)
                payload = self._read_exact(conn, length)
                r = kp.Reader(payload)
                api_key = r.int16()
                api_version = r.int16()
                corr = r.int32()
                r.string()  # client id
                body = self._dispatch(api_key, api_version, r)
                resp = kp.enc_int32(corr) + body
                conn.sendall(kp.enc_int32(len(resp)) + resp)
        except (ConnectionError, OSError):
            return

    @staticmethod
    def _read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def _dispatch(self, api_key, api_version, r: kp.Reader) -> bytes:
        if api_key == kp.API_VERSIONS:
            keys = [kp.API_PRODUCE, kp.API_FETCH, kp.API_LIST_OFFSETS,
                    kp.API_METADATA, kp.API_VERSIONS]
            out = kp.enc_int16(0) + kp.enc_int32(len(keys))
            for k in keys:
                out += kp.enc_int16(k) + kp.enc_int16(0) + kp.enc_int16(4)
            return out
        if api_key == kp.API_METADATA:
            n = r.int32()
            wanted = [r.string() for _ in range(n)]
            out = kp.enc_int32(1)  # brokers
            out += (kp.enc_int32(0) + kp.enc_string("127.0.0.1")
                    + kp.enc_int32(self.port) + kp.enc_string(None))
            out += kp.enc_int32(0)  # controller id
            out += kp.enc_int32(len(wanted))
            for t in wanted:
                logs = self.logs.get(t)
                out += kp.enc_int16(0 if logs is not None else 3)
                out += kp.enc_string(t) + kp.enc_int8(0)
                out += kp.enc_int32(len(logs or []))
                for pid in range(len(logs or [])):
                    out += (kp.enc_int16(0) + kp.enc_int32(pid)
                            + kp.enc_int32(0) + kp.enc_int32(0)
                            + kp.enc_int32(0))
            return out
        if api_key == kp.API_LIST_OFFSETS:
            r.int32()  # replica
            r.int32()  # topic count (assume 1)
            topic = r.string()
            r.int32()  # partition count (assume 1)
            pid = r.int32()
            ts = r.int64()
            log = self.logs[topic][pid]
            offset = 0 if ts == -2 else len(log)
            return (kp.enc_int32(1) + kp.enc_string(topic) + kp.enc_int32(1)
                    + kp.enc_int32(pid) + kp.enc_int16(0) + kp.enc_int64(-1)
                    + kp.enc_int64(offset))
        if api_key == kp.API_FETCH:
            r.int32()  # replica
            r.int32()  # max wait
            r.int32()  # min bytes
            r.int32()  # max bytes
            r.int8()   # isolation
            r.int32()  # topic count (assume 1)
            topic = r.string()
            n_parts = r.int32()
            wanted = []
            for _ in range(n_parts):
                pid = r.int32()
                offset = r.int64()
                r.int32()  # partition max bytes
                wanted.append((pid, offset))
            out = (kp.enc_int32(0)  # throttle
                   + kp.enc_int32(1) + kp.enc_string(topic)
                   + kp.enc_int32(len(wanted)))
            for pid, offset in wanted:
                err = 0
                if self.force_error and self.force_error[0] == pid:
                    err = self.force_error[1]
                log = self.logs[topic][pid]
                chunk = log[offset:offset + 100]
                records = kp.encode_record_batch(chunk, base_offset=offset) \
                    if chunk and not err else b""
                out += (kp.enc_int32(pid) + kp.enc_int16(err)
                        + kp.enc_int64(len(log)) + kp.enc_int64(len(log))
                        + kp.enc_int32(0)  # aborted txns
                        + kp.enc_bytes(records))
            return out
        if api_key == kp.API_PRODUCE:
            r.string()  # transactional id
            r.int16()   # acks
            r.int32()   # timeout
            r.int32()   # topic count (assume 1)
            topic = r.string()
            r.int32()   # partition count (assume 1)
            pid = r.int32()
            batch = r.bytes_()
            log = self.logs[topic][pid]
            base = len(log)
            for _off, key, value in kp.parse_record_batches(batch):
                log.append((key, value))
            return (kp.enc_int32(1) + kp.enc_string(topic) + kp.enc_int32(1)
                    + kp.enc_int32(pid) + kp.enc_int16(0)
                    + kp.enc_int64(base) + kp.enc_int64(-1)
                    + kp.enc_int32(0))
        raise AssertionError(f"unhandled api {api_key}")

    def close(self):
        self.server.close()


# ---------------------------------------------------------------------------
# the codecs, byte for byte
# ---------------------------------------------------------------------------

_blob = st.one_of(st.none(), st.binary(max_size=300))
_records = st.lists(st.tuples(_blob, _blob), min_size=1, max_size=12)


@settings(max_examples=60, deadline=None)
@given(v=st.integers(-(2**63), 2**63 - 1))
def test_integer_encoders_match_jax(v):
    for bits, name in ((8, "enc_int8"), (16, "enc_int16"),
                       (32, "enc_int32"), (64, "enc_int64")):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        x = min(max(v, lo), hi)
        assert getattr(kp, name)(x) == getattr(jkp, name)(x)
    assert kp.enc_varint(v) == jkp.enc_varint(v)
    assert kp.Reader(kp.enc_varint(v)).varint() == v


@settings(max_examples=60, deadline=None)
@given(s=st.one_of(st.none(), st.text(max_size=40)), b=_blob)
def test_string_and_bytes_encoders_match_jax(s, b):
    assert kp.enc_string(s) == jkp.enc_string(s)
    assert kp.enc_bytes(b) == jkp.enc_bytes(b)
    r = kp.Reader(kp.enc_string(s) + kp.enc_bytes(b))
    assert (r.string(), r.bytes_()) == (s, b)


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=2000))
def test_crc32c_matches_jax(data):
    assert kp.crc32c(data) == jkp.crc32c(data)


def test_crc32c_known_answer():
    # Castagnoli of b"123456789" (RFC 3720's check value)
    assert kp.crc32c(b"123456789") == 0xE3069283


@settings(max_examples=80, deadline=None)
@given(batches=st.lists(st.tuples(_records, st.integers(0, 2**40),
                                  st.integers(0, 2**41)),
                        min_size=1, max_size=4),
       cut=st.integers(0, 40))
def test_record_batches_match_jax(batches, cut):
    """Each batch's bytes, with its CRC32C, equal the JAX module's; the
    records parsed back are the JAX module's, from the whole concatenation
    and from one whose tail is cut (a partial batch is skipped)."""
    blob = b""
    for records, base, ts in batches:
        mine = kp.encode_record_batch(records, base_offset=base,
                                      first_timestamp=ts)
        assert mine == jkp.encode_record_batch(records, base_offset=base,
                                               first_timestamp=ts)
        blob += mine
    for data in (blob, blob[:len(blob) - cut]):
        got = list(kp.parse_record_batches(data))
        want = list(jkp.parse_record_batches(data))
        assert got == want
    first = batches[0]
    assert list(kp.parse_record_batches(kp.encode_record_batch(
        first[0], base_offset=first[1], first_timestamp=first[2]))) == [
        (first[1] + i, k, v) for i, (k, v) in enumerate(first[0])]


def test_control_batch_and_refusals_match_jax():
    """A control batch yields the CONTROL marker at its last offset in both
    packages (never a tombstone); pre-v2 and compressed batches raise."""
    blob = bytearray(kp.encode_record_batch([(b"k", None), (b"j", b"v")],
                                            base_offset=3))
    struct.pack_into(">h", blob, 21, 0x20)  # attributes: control batch
    got = list(kp.parse_record_batches(bytes(blob)))
    want = list(jkp.parse_record_batches(bytes(blob)))
    assert len(got) == len(want) == 1
    assert got[0][0] == want[0][0] == 4
    assert got[0][1] is kp.CONTROL and got[0][2] is kp.CONTROL
    tomb = list(kp.parse_record_batches(kp.encode_record_batch(
        [(b"k", None)], base_offset=3)))
    assert tomb == [(3, b"k", None)]
    for offset, value in ((16, 1), (21, 0x01)):  # magic 1; gzip
        bad = bytearray(kp.encode_record_batch([(None, b"x")]))
        if offset == 16:
            struct.pack_into(">b", bad, offset, value)
        else:
            struct.pack_into(">h", bad, offset, value)
        for mod in (kp, jkp):
            with pytest.raises(mod.KafkaProtocolError) as e:
                list(mod.parse_record_batches(bytes(bad)))
            assert e.value.code == -1


def test_varint_zigzag_edges():
    for v in (0, -1, 1, -64, 63, 64, -65, 300, -300, 2**31 - 1,
              -(2**31), 2**40, -(2**40)):
        assert kp.enc_varint(v) == jkp.enc_varint(v)
        assert kp.Reader(kp.enc_varint(v)).varint() == v, v


def test_record_batch_empty_and_single():
    assert list(kp.parse_record_batches(b"")) == []
    blob = kp.encode_record_batch([(None, None)])
    assert list(kp.parse_record_batches(blob)) == [(0, None, None)]


# ---------------------------------------------------------------------------
# the clients against one broker
# ---------------------------------------------------------------------------

def test_clients_produce_fetch_roundtrip_like_jax():
    """Each package's client produces to its own topic of one broker; every
    call answers the same in both."""
    broker = FakeBroker({"jax": 2, "port": 2})
    try:
        seen = {}
        for name, mod in (("jax", jkp), ("port", kp)):
            c = mod.KafkaClient(f"127.0.0.1:{broker.port}")
            out = [sorted(c.api_versions().items()), c.metadata(name)]
            out.append(c.produce(name, 0, [(None, b"a"), (b"k", b"b")]))
            out.append(c.produce(name, 1, [(None, b"c")]))
            out.append(c.produce(name, 0, [(None, None)]))
            out += [c.list_offsets(name, 0, -2), c.list_offsets(name, 0, -1)]
            out.append(c.fetch(name, 0, 0))
            out.append(c.fetch(name, 0, 1))
            out.append(c.fetch_many(name, {0: 2, 1: 0}))
            c.close()
            seen[name] = out
        assert seen["port"] == seen["jax"]
        assert seen["port"][1] == {0: 0, 1: 0}
        assert [v for _o, _k, v in seen["port"][7]] == [b"a", b"b", None]
        assert broker.logs["port"] == broker.logs["jax"]
    finally:
        broker.close()


def test_offset_out_of_range_carries_partition():
    broker = FakeBroker({"t": 2})
    try:
        c = kp.KafkaClient(f"127.0.0.1:{broker.port}")
        c.produce("t", 0, [(None, b"a")])
        c.produce("t", 1, [(None, b"b")])
        broker.force_error = (1, 1)  # partition 1 -> OFFSET_OUT_OF_RANGE
        with pytest.raises(kp.KafkaProtocolError) as exc:
            c.fetch_many("t", {0: 0, 1: 5})
        assert exc.value.code == 1 and exc.value.partition == 1
        broker.force_error = None
        got = c.fetch_many("t", {0: 0, 1: 0})
        assert [v for _o, _k, v in got[0]] == [b"a"]
        assert [v for _o, _k, v in got[1]] == [b"b"]
        c.close()
    finally:
        broker.close()


# ---------------------------------------------------------------------------
# pw.io.kafka under pw.run, in both packages
# ---------------------------------------------------------------------------

def _side(side: str):
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
        from pathway_tpu.internals.parse_graph import G
        from pathway_tpu.io import _datasource
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.io import _datasource
    return types.SimpleNamespace(pw=pw, streaming=streaming, G=G,
                                 ds=_datasource)


def _read_until(m, settings_, topic, schema, fmt, want: int):
    """Run ``pw.io.kafka.read`` under ``pw.run`` until ``want`` rows came;
    returns [(key, row dict)] in arrival order."""
    t = m.pw.io.kafka.read(settings_, topic=topic, schema=schema,
                           format=fmt, autocommit_duration_ms=30)
    got, lock, errors = [], threading.Lock(), []
    m.pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                      got.append((int(key), row)))

    def run():
        try:
            m.pw.run()
        except Exception as e:  # re-raised by the caller's assert
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + DEADLINE_S
        while True:
            with lock:
                n = len(got)
            if n >= want or errors:
                break
            assert time.monotonic() < deadline, (n, want)
            time.sleep(0.02)
    finally:
        m.streaming.stop_all()
        th.join(DEADLINE_S)
        m.G.clear()
    assert not th.is_alive()
    assert not errors, errors
    return got


def test_connector_write_then_read_matches_jax(monkeypatch):
    """pw.io.kafka.write in each package into its own topic (2
    partitions), then pw.io.kafka.read of both topics in each package: the
    messages equal, and the rows read, with their keys, equal."""
    broker = FakeBroker({"jax": 2, "port": 2})
    try:
        settings_ = {"bootstrap.servers": f"127.0.0.1:{broker.port}"}
        for name in ("jax", "port"):
            m = _side("jax" if name == "jax" else "torch")
            m.G.clear()
            src = m.pw.debug.table_from_markdown("""
            word | n
            tpu  | 1
            mesh | 2
            slab | 3
            """)
            m.pw.io.kafka.write(src, settings_, name, format="json")
            m.pw.run()
            m.G.clear()
        assert sum(len(log) for log in broker.logs["port"]) == 3
        # the same messages (JSON of the same rows, time and diff)
        assert broker.logs["port"] == broker.logs["jax"]
        rows = {}
        for side in ("jax", "torch"):
            m = _side(side)
            schema = m.pw.schema_from_types(word=str, n=int, time=int,
                                            diff=int)
            for topic in ("jax", "port"):
                monkeypatch.setattr(m.ds, "_source_counter",
                                    itertools.count(5))
                got = _read_until(m, settings_, topic, schema, "json", 3)
                rows[side, topic] = sorted(
                    (k, tuple(sorted(r.items()))) for k, r in got)
        assert rows["torch", "port"] == rows["jax", "port"] == \
            rows["torch", "jax"] == rows["jax", "jax"]
        assert sorted(dict(r)["word"] for _, r in rows["torch", "port"]) \
            == ["mesh", "slab", "tpu"]
    finally:
        broker.close()


def test_raw_read_keeps_tombstones_like_jax(monkeypatch):
    """format="raw": a ``data`` bytes column, tombstones as data=None, in
    partition and offset order; json skips tombstones and bad JSON."""
    broker = FakeBroker({"raw": 3})
    try:
        c = kp.KafkaClient(f"127.0.0.1:{broker.port}")
        c.produce("raw", 0, [(None, b"a"), (b"k", None)])
        c.produce("raw", 2, [(None, b'{"x": 1}'), (None, b"not json")])
        c.close()
        settings_ = {"bootstrap.servers": f"127.0.0.1:{broker.port}"}
        got = {}
        for side in ("jax", "torch"):
            m = _side(side)
            monkeypatch.setattr(m.ds, "_source_counter", itertools.count(9))
            got[side, "raw"] = _read_until(m, settings_, "raw", None, "raw",
                                           4)
            monkeypatch.setattr(m.ds, "_source_counter", itertools.count(9))
            got[side, "json"] = _read_until(
                m, settings_, "raw", m.pw.schema_from_types(x=int), "json",
                1)
        assert got["torch", "raw"] == got["jax", "raw"]
        assert [r["data"] for _, r in got["torch", "raw"]] == [
            b"a", None, b'{"x": 1}', b"not json"]
        assert got["torch", "json"] == got["jax", "json"]
        assert [r["x"] for _, r in got["torch", "json"]] == [1]
    finally:
        broker.close()


def test_unported_options_raise_naming_their_item():
    import pathway_tpu_torch as pw

    settings_ = {"bootstrap.servers": "127.0.0.1:9"}
    with pytest.raises(NotImplementedError, match="item 6a"):
        pw.io.kafka.read(settings_, topic="t", persistent_id="p")
    with pytest.raises(NotImplementedError, match="item 6c"):
        pw.io.kafka.read(settings_, topic="t", connector_policy=object())
    with pytest.raises(NotImplementedError, match="item 6c"):
        pw.io.kafka.read({**settings_, "security.protocol": "sasl_ssl"},
                         topic="t")
    with pytest.raises(NotImplementedError, match="item 6c"):
        pw.io.kafka.read_from_upstash("h:1", "u", "p", "t")
    src = pw.io.kafka.KafkaSource(settings_, "t", "raw",
                                  pw.schema_from_types(data=bytes))
    with pytest.raises(NotImplementedError, match="item 6a"):
        src.seek_offsets({0: 3})
    with pytest.raises(ValueError, match="key"):
        pw.io.kafka.write(pw.debug.table_from_markdown("a\n1"), settings_,
                          "t", format="json", key="a")


# ---------------------------------------------------------------------------
# BASELINE.md config 5 on the CPU: a Kafka stream into a 4-shard index
# ---------------------------------------------------------------------------

C5_DOCS = 64
C5_QUERIES = 8


def _c5_docs() -> tuple[list[str], list[str]]:
    import numpy as np

    rng = np.random.default_rng(5)
    vocab = [f"word{i}" for i in range(300)]
    docs = [" ".join(vocab[j] for j in rng.integers(0, 300, size=m))
            for m in rng.integers(4, 24, size=C5_DOCS)]
    fresh = [" ".join(vocab[j] for j in rng.integers(0, 300, size=9))
             for _ in range(C5_QUERIES // 2)]
    # half the queries are copies of documents, half fresh texts
    return docs, [docs[7 * i] for i in range(C5_QUERIES // 2)] + fresh


def _c5_side(side: str, params):
    """(pw, streaming, G, datasource module, mesh module, the KNN factory
    class, a 4-shard mesh, the embedder) of one package."""
    if side == "jax":
        import jax.numpy as jnp

        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
        from pathway_tpu.internals.parse_graph import G
        from pathway_tpu.io import _datasource
        from pathway_tpu.models.encoder import EncoderConfig
        from pathway_tpu.parallel import mesh
        from pathway_tpu.stdlib.indexing import nearest_neighbors
        from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder

        m4 = mesh.make_mesh(mesh.MeshConfig(data=4))
        emb = JaxEncoderEmbedder(
            config=EncoderConfig.tiny(compute_dtype=jnp.float32,
                                      pooling="mean"), params=params)
    else:
        import torch

        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.io import _datasource
        from pathway_tpu_torch.models.encoder import EncoderConfig
        from pathway_tpu_torch.parallel import mesh
        from pathway_tpu_torch.stdlib.indexing import nearest_neighbors
        from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

        m4 = mesh.make_mesh(mesh.MeshConfig(data=4),
                            devices=[torch.device("cpu")] * 4)
        emb = EncoderEmbedder(
            config=EncoderConfig.tiny(compute_dtype=torch.float32,
                                      pooling="mean"),
            params=params, device="cpu")
    return types.SimpleNamespace(
        pw=pw, streaming=streaming, G=G, ds=_datasource, mesh=mesh,
        factory=nearest_neighbors.BruteForceKnnFactory, m4=m4, emb=emb)


def _config5_run(side: str, params, broker, docs_topic, query_topic,
                 queries, monkeypatch):
    """Config 5 in one package: documents from a 4-partition Kafka topic,
    the encoder as a UDF into ``mesh="auto"`` under a 4-shard mesh, queries
    from a second topic produced once the index holds every document,
    answered ``query_as_of_now`` (k=3). Returns (the built index, each
    query's text -> its answer's reply keys and doc ids)."""
    m = _c5_side(side, params)
    m.G.clear()
    monkeypatch.setattr(m.ds, "_source_counter", itertools.count(11))
    built = []
    real_build = m.factory.build

    def build(self):
        built.append(real_build(self))
        return built[-1]

    monkeypatch.setattr(m.factory, "build", build)
    from pathway_tpu_torch.io.kafka._protocol import KafkaClient

    settings_ = {"bootstrap.servers": f"127.0.0.1:{broker.port}"}
    pw = m.pw
    docs = pw.io.kafka.read(settings_, topic=docs_topic,
                            schema=pw.schema_from_types(doc_id=int, doc=str),
                            format="json", autocommit_duration_ms=20)
    qs = pw.io.kafka.read(settings_, topic=query_topic,
                          schema=pw.schema_from_types(query=str),
                          format="json", autocommit_duration_ms=20)
    index = pw.stdlib.indexing.default_brute_force_knn_document_index(
        docs.doc, docs, embedder=m.emb, dimensions=64, mesh="auto",
        **({} if side == "jax" else {"device": "cpu"}))
    res = index.query_as_of_now(qs.query, number_of_matches=3)
    res = res.select(query=qs.restrict(res).query, ids=res._pw_index_reply_id,
                     doc_ids=res.doc_id)
    answers, lock, errors = {}, threading.Lock(), []

    def on_change(key, row, time, is_addition):
        if is_addition:
            with lock:
                answers[row["query"]] = (tuple(int(k) for k in row["ids"]),
                                         tuple(row["doc_ids"]))

    pw.io.subscribe(res, on_change)

    def run():
        try:
            pw.run()
        except Exception as e:  # re-raised by the caller's assert
            errors.append(e)

    with m.mesh.use_mesh(m.m4):
        th = threading.Thread(target=run, daemon=True)
        th.start()
        try:
            deadline = time.monotonic() + DEADLINE_S
            while not (built and len(built[0]) == C5_DOCS) and not errors:
                assert time.monotonic() < deadline, "documents not indexed"
                time.sleep(0.02)
            c = KafkaClient(settings_["bootstrap.servers"])
            c.produce(query_topic, 0, [
                (None, json.dumps({"query": q}).encode()) for q in queries])
            c.close()
            while True:
                with lock:
                    n = len(answers)
                if n == len(queries) or errors:
                    break
                assert time.monotonic() < deadline, (n, len(queries))
                time.sleep(0.02)
        finally:
            m.streaming.stop_all()
            th.join(DEADLINE_S)
            m.G.clear()
    assert not th.is_alive()
    assert not errors, errors
    return built[0], answers


@pytest.mark.parametrize("workers", [1, 4])
def test_config5_kafka_into_sharded_index_matches_jax(workers, monkeypatch):
    """BASELINE.md config 5 at a small size (tests/test_parallel.py:223's
    pipeline fed by Kafka): 64 documents on a 4-partition topic, a 2-layer
    encoder of 64 wide (the same weights in both packages), ``mesh="auto"``
    under a 4-shard mesh (the JAX package's 8-device CPU mesh cut to
    data=4, the port's ``[cpu] * 4``), PATHWAY_THREADS workers. Each
    package builds its sharded index, holds every document once, and
    answers each query with the same keys, in the same order; copies of
    documents find their document first."""
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.parallel.sharded_knn import ShardedKnnIndex

    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    params = init_params_host(0, EncoderConfig.tiny())
    docs, queries = _c5_docs()
    broker = FakeBroker({"docs": 4, "queries_jax": 1, "queries_torch": 1})
    try:
        c = kp.KafkaClient(f"127.0.0.1:{broker.port}")
        for p in range(4):
            c.produce("docs", p, [
                (None, json.dumps({"doc_id": i, "doc": docs[i]}).encode())
                for i in range(p, C5_DOCS, 4)])
        c.close()
        got = {}
        for side in ("jax", "torch"):
            got[side] = _config5_run(side, params, broker, "docs",
                                     f"queries_{side}", queries, monkeypatch)
    finally:
        broker.close()
    t_index, t_answers = got["torch"]
    j_index, j_answers = got["jax"]
    assert isinstance(t_index, ShardedKnnIndex) and t_index.n_shards == 4
    assert type(j_index).__name__ == "PagedShardedKnnIndex"
    assert len(t_index) == len(j_index) == C5_DOCS
    # each document once: the index's keys are the table's rows
    assert sorted(int(k) for k in t_index._key_to_slot) == \
        sorted(int(k) for k in j_index._key_to_slot)
    assert t_answers == j_answers
    assert len(t_answers) == C5_QUERIES
    for i in range(C5_QUERIES // 2):
        assert t_answers[docs[7 * i]][1][0] == 7 * i
