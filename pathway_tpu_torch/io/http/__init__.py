"""pw.io.http — the REST server connector — port of
pathway_tpu/io/http/__init__.py (reference: python/pathway/io/http/
_server.py:624 + PathwayWebserver:329).

Each HTTP request becomes a row in a query table; ``response_writer``
resolves the waiting request when the pipeline emits the row with the
same key. This is the serving front door of the RAG stack.

The JAX package serves with aiohttp. The port's server is written on the
standard library alone — ``asyncio.start_server`` and a small HTTP/1.1
parser on one event-loop thread — with the reference's wire behaviour:
the same routes, status codes (200, 204, 400, 404, 500), bodies, JSON and
text content types, ``/_schema`` (YAML by default, ``?format=json``),
CORS headers and preflight, and the ``X-Pathway-Request-Id`` header.
Requests are read with ``Content-Length`` bodies; keep-alive is honoured
for HTTP/1.1 clients. Not ported: the streaming HTTP client and sink
(``read``/``write``), and ``durable_ack`` / ``persistent_id``, which need
persistence (ROADMAP queue 1, item 6a) and raise. QoS admission (the 503
``QueryShedError`` path) is not ported either (item 6b); the admission
gate is a no-op, as in the JAX package with QoS off.
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import json as _json
import os as _os
import re
import threading
import time as _time
from http import HTTPStatus
from typing import Any
from urllib.parse import parse_qsl, unquote

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Pointer, hash_values
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Plan, Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._datasource import DataSource, Session

_PERSISTENCE = "ROADMAP queue 1, item 6a: persistence and snapshots"

# -- request-id assignment (serving-path SLO tracing) -------------------------
# Every request entering the webserver gets an id at ingress — adopted from
# an inbound X-Pathway-Request-Id header when a caller already named the
# query, minted fresh otherwise — echoed back in the X-Pathway-Request-Id
# response header and carried (out of band, never inside engine rows)
# through the request tracker (engine/request_tracker.py).

_rid_counter = itertools.count(1)
_rid_prefix: str | None = None


def _next_request_id() -> str:
    global _rid_prefix
    if _rid_prefix is None:
        _rid_prefix = _os.urandom(3).hex()
    return f"{_rid_prefix}-{next(_rid_counter):06d}"


_RID_MAX_LEN = 128
_RID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.:")


def _adopt_request_id(inbound: str | None) -> str:
    """Adopt a sane inbound ``X-Pathway-Request-Id`` or mint a fresh one:
    an id with characters outside the safe set, or past the length cap,
    gets a local id instead (the response carries the id actually used)."""
    if inbound:
        rid = inbound.strip()
        if rid and len(rid) <= _RID_MAX_LEN \
                and all(c in _RID_OK for c in rid):
            return rid
    return _next_request_id()


class RequestContext:
    """Ingress metadata handed to route handlers that accept a second
    positional argument: the assigned request id and the arrival stamp
    (perf_counter) taken before any parsing."""

    __slots__ = ("request_id", "ingress_t")

    def __init__(self, request_id: str, ingress_t: float):
        self.request_id = request_id
        self.ingress_t = ingress_t


def _accepts_ctx(handler) -> bool:
    """Does the handler take (payload, ctx)? Probed once at register time
    so plain single-argument handlers keep working unchanged."""
    try:
        sig = inspect.signature(handler)
    except (TypeError, ValueError):
        return False
    positional = 0
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            positional += 1
        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
            return True
    return positional >= 2


class _Reply:
    """One response: status, body bytes, content type, extra headers."""

    __slots__ = ("status", "body", "content_type", "headers")

    def __init__(self, status: int, body: bytes = b"",
                 content_type: str | None = "text/plain; charset=utf-8",
                 headers: dict | None = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = dict(headers or {})

    @classmethod
    def text(cls, text: str, status: int = 200, headers=None,
             content_type: str = "text/plain") -> "_Reply":
        return cls(status, text.encode("utf-8"),
                   f"{content_type}; charset=utf-8", headers)

    @classmethod
    def json(cls, value, headers=None) -> "_Reply":
        # aiohttp's json_response: json.dumps with its default separators
        return cls(200, _json.dumps(value).encode("utf-8"),
                   "application/json; charset=utf-8", headers)


_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}
_MAX_HEADER_LINES = 100


class PathwayWebserver:
    """Shared HTTP server; several rest_connectors can register routes on
    one (reference: _server.py:329, OpenAPI docs at /_schema). Runs on
    its own event-loop thread from :meth:`start` until :meth:`stop`."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 with_schema_endpoint: bool = True, with_cors: bool = False):
        self.host = host
        self.port = port
        self._routes: dict[tuple[str, str], Any] = {}
        # (method, route) -> "custom" | "raw"; keyed per method so two
        # connectors sharing a route cannot clobber each other's format
        self._formats: dict[tuple[str, str], str] = {}
        # (method, route) -> handler takes (payload, RequestContext)
        self._wants_ctx: dict[tuple[str, str], bool] = {}
        self._openapi: dict = {"openapi": "3.0.3",
                               "info": {"title": "pathway-tpu", "version": "1"},
                               "paths": {}}
        self._started = threading.Event()
        self._start_error: BaseException | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._shutdown: asyncio.Event | None = None
        self._lock = threading.Lock()
        self.with_schema_endpoint = with_schema_endpoint
        # allow cross-origin requests (reference: aiohttp_cors with
        # allow-all defaults, _server.py:361-371): plain headers + OPTIONS
        # preflight
        self.with_cors = with_cors

    def register(self, route: str, methods: tuple[str, ...], handler,
                 schema: type[sch.Schema] | None,
                 format: str = "custom") -> None:
        keys = [(m.upper(), route) for m in methods]
        for key in keys:  # validate every method before mutating any
            if self._formats.get(key, format) != format:
                raise ValueError(
                    f"route {key[0]} {route} is already registered with "
                    f"input format {self._formats[key]!r}; refusing to "
                    f"re-register it as {format!r}")
        wants_ctx = _accepts_ctx(handler)
        for key in keys:
            self._routes[key] = handler
            self._formats[key] = format
            self._wants_ctx[key] = wants_ctx
        if schema is not None:
            props = {
                c.name: {"type": _openapi_type(c.dtype)}
                for c in schema.columns().values()
            }
            self._openapi["paths"][route] = {
                m.lower(): {
                    "requestBody": {"content": {"application/json": {
                        "schema": {"type": "object", "properties": props}}}},
                    "responses": {"200": {"description": "ok"}},
                } for m in methods
            }

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Bind and serve on a ``webserver`` engine thread (idempotent).
        With ``port=0`` the bound port is published in ``self.port``. A
        bind failure raises here."""
        with self._lock:
            if self._thread is None:
                self._started.clear()
                self._start_error = None
                from pathway_tpu_torch.engine.threads import spawn

                self._thread = spawn(self._run_loop, name="webserver")
        self._started.wait(timeout=10)
        if self._start_error is not None:
            raise self._start_error

    def stop(self, timeout: float = 5.0) -> None:
        """Close the listening socket, cancel open connections and join
        the loop thread (idempotent). Requests still waiting for an
        answer get their connection closed."""
        with self._lock:
            thread, loop, shutdown = self._thread, self._loop, self._shutdown
            self._thread = None
        if thread is None:
            return
        if loop is not None and shutdown is not None:
            try:
                loop.call_soon_threadsafe(shutdown.set)
            except RuntimeError:
                pass  # the loop already ended
        thread.join(timeout)

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._main())
        except BaseException as e:  # noqa: BLE001 — handed to start()
            self._start_error = e
        finally:
            self._started.set()
            loop.close()

    async def _main(self) -> None:
        self._shutdown = asyncio.Event()
        conns: set[asyncio.Task] = set()

        async def on_conn(reader, writer):
            task = asyncio.current_task()
            conns.add(task)
            try:
                await self._serve_conn(reader, writer)
            except (asyncio.CancelledError, ConnectionError,
                    asyncio.IncompleteReadError):
                pass
            finally:
                conns.discard(task)
                writer.close()

        server = await asyncio.start_server(on_conn, self.host, self.port)
        if self.port == 0:
            # ephemeral port requested: publish the bound one so clients
            # (tests, bench) can find the endpoint
            self.port = server.sockets[0].getsockname()[1]
        self._started.set()
        await self._shutdown.wait()
        server.close()
        for task in list(conns):
            task.cancel()
        if conns:
            await asyncio.gather(*conns, return_exceptions=True)

    # -- HTTP/1.1 ---------------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        while True:
            line = await reader.readline()
            if not line:
                return
            parts = line.decode("latin-1").rstrip("\r\n").split(" ")
            if len(parts) != 3 or not parts[2].startswith("HTTP/"):
                await self._write(writer, _Reply.text(
                    "Bad Request", status=400), keep_alive=False)
                return
            method, target, version = parts
            headers: dict[str, str] = {}
            for _ in range(_MAX_HEADER_LINES):
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                name, _, value = h.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            body = b""
            if headers.get("transfer-encoding", "").lower() == "chunked":
                body = await _read_chunked(reader)
            else:
                length = int(headers.get("content-length") or 0)
                if length:
                    body = await reader.readexactly(length)
            conn = headers.get("connection", "").lower()
            keep_alive = (conn != "close" if version == "HTTP/1.1"
                          else conn == "keep-alive")
            reply = await self._dispatch(method.upper(), target, headers,
                                         body)
            await self._write(writer, reply, keep_alive)
            if not keep_alive:
                return

    async def _write(self, writer: asyncio.StreamWriter, reply: _Reply,
                     keep_alive: bool) -> None:
        try:
            reason = HTTPStatus(reply.status).phrase
        except ValueError:
            reason = ""
        head = [f"HTTP/1.1 {reply.status} {reason}"]
        if reply.content_type is not None:
            head.append(f"Content-Type: {reply.content_type}")
        head.append(f"Content-Length: {len(reply.body)}")
        head.append("Connection: " + ("keep-alive" if keep_alive
                                      else "close"))
        head += [f"{k}: {v}" for k, v in reply.headers.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                     + reply.body)
        await writer.drain()

    async def _dispatch(self, method: str, target: str, headers: dict,
                        body: bytes) -> _Reply:
        if self.with_cors and method == "OPTIONS":
            return _Reply(204, content_type=None, headers=_CORS)
        reply = await self._dispatch_inner(method, target, headers, body)
        if self.with_cors:
            reply.headers.update(_CORS)
        return reply

    async def _dispatch_inner(self, method: str, target: str,
                              headers: dict, body: bytes) -> _Reply:
        # ingress stamp BEFORE any parsing: the request id is born here
        # and the ingress_wait stage starts here
        t_ingress = _time.perf_counter()
        path, _, qs = target.partition("?")
        path = unquote(path)
        query: dict[str, str] = {}
        for k, v in parse_qsl(qs, keep_blank_values=True):
            query.setdefault(k, v)  # the first value of a repeated name
        route_key = (method, path)
        handler = self._routes.get(route_key)
        if handler is None:
            if path == "/_schema" and self.with_schema_endpoint:
                # reference serves yaml by default with ?format=json
                # (_server.py:427-445)
                fmt = query.get("format", "yaml")
                if fmt == "json":
                    return _Reply.json(self._openapi)
                if fmt != "yaml":
                    return _Reply.text(
                        f"Unknown format: {fmt!r}. Supported "
                        "formats: 'json', 'yaml'", status=400)
                return _Reply.text(_yaml_dump(self._openapi),
                                   content_type="text/x-yaml")
            return _Reply.text("no such route", status=404)
        rid = _adopt_request_id(headers.get("x-pathway-request-id"))
        rid_header = {"X-Pathway-Request-Id": rid}
        try:
            fmt = self._formats.get(route_key, "custom")
            if fmt == "raw":
                # raw format: the whole body IS the query value, for
                # every method — a bodyless GET yields {'query': ''}
                # (reference: _server.py:526-527 QUERY_SCHEMA_COLUMN)
                payload = {"query": body.decode("utf-8", "replace")}
            elif method in ("POST", "PUT", "PATCH"):
                try:
                    payload = _json.loads(body.decode("utf-8"))
                    if not isinstance(payload, dict):
                        payload = {}
                except Exception:
                    # reference custom-format semantics: unparseable
                    # body -> {}, missing required fields then 400
                    payload = {}
                for param, value in query.items():
                    payload.setdefault(param, value)
            else:
                payload = dict(query)
            if self._wants_ctx.get(route_key):
                result = handler(payload, RequestContext(rid, t_ingress))
            else:
                result = handler(payload)
            if inspect.isawaitable(result):
                result = await result
            if isinstance(result, (dict, list)):
                return _Reply.json(result, headers=rid_header)
            return _Reply.text(str(result), headers=rid_header)
        except _BadRequest as e:
            return _Reply.text(str(e), status=400, headers=rid_header)
        except Exception as e:
            return _Reply.text(repr(e), status=500, headers=rid_header)


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    out = bytearray()
    while True:
        size = int((await reader.readline()).split(b";")[0].strip() or b"0",
                   16)
        if size == 0:
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass  # trailers
            return bytes(out)
        out += await reader.readexactly(size)
        await reader.readline()


# -- /_schema as YAML, without a YAML library -----------------------------

_YAML_PLAIN = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./ -]*$")
_YAML_WORDS = frozenset(("true", "false", "yes", "no", "on", "off", "null",
                         "y", "n"))


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if _YAML_PLAIN.match(s) and s.lower() not in _YAML_WORDS \
            and not s.endswith(" "):
        return s
    return "'" + s.replace("'", "''") + "'"


def _yaml_dump(obj, indent: int = 0) -> str:
    """Block-style YAML of the OpenAPI document (nested dicts of
    scalars): what ``yaml.safe_dump(..., sort_keys=False)`` loads back to
    the same value. Lists go in JSON's flow style, which YAML reads."""
    pad = "  " * indent
    lines = []
    for k, v in obj.items():
        key = _yaml_scalar(str(k))
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{key}:\n" + _yaml_dump(v, indent + 1))
        elif isinstance(v, dict):
            lines.append(f"{pad}{key}: {{}}\n")
        elif isinstance(v, (list, tuple)):
            lines.append(f"{pad}{key}: {_json.dumps(list(v))}\n")
        else:
            lines.append(f"{pad}{key}: {_yaml_scalar(v)}\n")
    return "".join(lines)


class _BadRequest(ValueError):
    pass


def _openapi_type(d) -> str:
    base = dt.unoptionalize(d)
    if base is dt.INT:
        return "integer"
    if base is dt.FLOAT:
        return "number"
    if base is dt.BOOL:
        return "boolean"
    return "string"


class RestSource(DataSource):
    name = "rest"
    # request-scoped tracing (engine/request_tracker.py): the streaming
    # runtime wires the run's tracker here when the flight recorder is on;
    # None keeps every stamp a dead branch
    request_tracker = None

    def __init__(self, webserver: PathwayWebserver, route: str,
                 methods: tuple[str, ...], schema,
                 delete_completed_queries: bool,
                 autocommit_duration_ms=50, request_validator=None,
                 format: str = "custom"):
        super().__init__(schema, autocommit_duration_ms)
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.format = format
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        self.pending: dict[Pointer, tuple[asyncio.AbstractEventLoop,
                                          asyncio.Event, list]] = {}
        self._session: Session | None = None
        self._seq = 0
        from pathway_tpu_torch.engine.locking import create_lock

        self._lock = create_lock("RestSource._lock")

    def run(self, session: Session) -> None:
        self._session = session

        async def handler(payload: dict, ctx=None):
            for col in self.schema.columns().values():
                if col.name not in payload:
                    if col.has_default_value:
                        payload[col.name] = col.default_value
                    else:
                        raise _BadRequest(
                            f"field {col.name!r} is required")
            if self.request_validator is not None:
                err = self.request_validator(payload)
                if err:
                    raise _BadRequest(str(err))
            # request-scoped span: the webserver-assigned id + ingress
            # stamp start it; the commit loop / scheduler / resolve add
            # their stamps; finish() in the finally aggregates (or drops
            # an unresolved span — client disconnect, handler error)
            tracker = self.request_tracker
            span = None
            if tracker is not None and ctx is not None:
                span = tracker.start(ctx.request_id, self.route,
                                     ctx.ingress_t)
            try:
                if span is not None:
                    # the admission gate (QoS, not ported) is a no-op:
                    # admission_wait reads ~0
                    tracker.admission(span)
                with self._lock:
                    self._seq += 1
                    seq = self._seq
                key, row = self.row_to_engine(payload, seq)
                key = hash_values("rest", self._uid, seq)
                loop = asyncio.get_running_loop()
                event = asyncio.Event()
                slot: list = [None]
                self.pending[key] = (loop, event, slot)
                if span is not None:
                    # registered BEFORE push: the commit loop may drain
                    # (and stamp tick pickup on) the row immediately
                    tracker.enqueued(span, key)
                session.push(key, row, 1)
                await event.wait()
                if self.delete_completed_queries:
                    session.push(key, row, -1)
                return slot[0]
            finally:
                if span is not None:
                    tracker.finish(span)

        self.webserver.register(self.route, self.methods, handler,
                                self.schema, format=self.format)
        self.webserver.start()
        # stay alive until the runtime requests stop (sources close when
        # run() returns), then take the server down with the run
        session.stopping.wait()
        self.webserver.stop()

    def resolve(self, key: Pointer, value: Any) -> None:
        tracker = self.request_tracker
        if tracker is not None:
            # stamped before waking the handler so the response_write
            # stage starts at resolution, not at event delivery
            tracker.resolved(key)
        entry = self.pending.pop(key, None)
        if entry is None:
            return
        loop, event, slot = entry
        slot[0] = value
        try:
            loop.call_soon_threadsafe(event.set)
        except RuntimeError:
            pass  # the server stopped: nobody is waiting any more


def rest_connector(host: str | None = None, port: int | None = None, *,
                   webserver: PathwayWebserver | None = None,
                   route: str = "/", schema: type[sch.Schema] | None = None,
                   methods: tuple[str, ...] = ("POST",),
                   autocommit_duration_ms: int | None = 50,
                   keep_queries: bool | None = None,
                   delete_completed_queries: bool = False,
                   request_validator=None,
                   format: str | None = None,
                   documentation=None,
                   persistent_id: str | None = None,
                   durable_ack: bool = False) -> tuple[Table, Any]:
    """Returns (query_table, response_writer). ``format="custom"``
    parses the JSON body and merges URL query params, 400-ing on missing
    required fields; ``format="raw"`` takes the whole request body as the
    ``query`` column. With no explicit format, a schemaless endpoint
    infers ``raw`` and a schema-ful one infers ``custom`` (reference:
    _server.py:50,525-535,733-736). ``persistent_id`` and
    ``durable_ack=True`` need persistence, which is not ported: they
    raise."""
    if persistent_id is not None or durable_ack:
        raise NotImplementedError(
            "rest_connector(persistent_id=..., durable_ack=True) is not "
            f"ported to pathway_tpu_torch yet ({_PERSISTENCE})")
    if format is None:
        format = "raw" if schema is None else "custom"
    if format not in ("custom", "raw"):
        raise ValueError(f"unknown endpoint input format: {format!r} "
                         "(use 'custom' or 'raw')")
    if webserver is None:
        webserver = PathwayWebserver(host or "0.0.0.0", port or 8080)
    if schema is None:
        schema = sch.schema_from_types(query=dt.ANY)
    if format == "raw" and "query" not in schema.column_names():
        raise ValueError(
            "'raw' endpoint input format requires a 'query' column "
            "in the schema")
    source = RestSource(webserver, route, methods, schema,
                        delete_completed_queries,
                        autocommit_duration_ms=autocommit_duration_ms,
                        request_validator=request_validator,
                        format=format)
    table = Table(Plan("input", datasource=source), schema, Universe(),
                  name=f"rest:{route}")

    def response_writer(response_table: Table) -> None:
        names = response_table.column_names()

        def binder(runner):
            def callback(time, delta):
                for key, row, diff in delta.entries:
                    if diff <= 0:
                        continue
                    if len(names) == 1:
                        value = row[0]
                    else:
                        value = dict(zip(names, row))
                    source.resolve(key, _jsonable(value))

            runner.subscribe(response_table, callback)

        G.add_output(binder, table=response_table, sink="http.response",
                     format="json")

    return table, response_writer


def _jsonable(value):
    if isinstance(value, Json):
        return value.value
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, Pointer):
        return str(value)
    import numpy as np

    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.integer, np.floating)):
        return value.item()
    return value
