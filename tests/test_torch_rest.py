"""The port's REST server (io/http, on the standard library) against the
JAX package's (aiohttp): the cases of tests/test_rest_formats.py and the
reference's status paths, sent as the same requests to both servers —
statuses, bodies and content types equal (``/_schema``'s YAML compared
as loaded values, since the port writes it without a YAML library).
Every request carries a 10 s deadline; every port server is stopped and
its thread joined."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import yaml

import pathway_tpu.io.http as jhttp
import pathway_tpu_torch.io.http as thttp

DEADLINE_S = 10.0


def _send(base: str, path: str, method: str = "GET", body: bytes | None = None,
          headers: dict | None = None):
    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=DEADLINE_S) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def _same(bases: dict, path: str, method: str = "GET", body=None,
          headers=None, parse=None):
    """Send the request to both servers; (status, content type, body) of
    the two replies must be equal. Returns the port's reply."""
    out = {}
    for side, base in bases.items():
        status, hdrs, text = _send(base, path, method, body, headers)
        value = parse(text) if parse is not None else text
        out[side] = (status, hdrs.get("Content-Type"), value, hdrs)
    assert out["torch"][:3] == out["jax"][:3]
    return out["torch"]


async def _echo(payload):
    return {"got": payload}


async def _boom(payload):
    raise ValueError("boom")


def _servers(register, **kwargs):
    """One JAX and one port webserver on free ports, set up by
    ``register(ws)``; returns ({side: base url}, port server)."""
    bases = {}
    tws = None
    for side, mod in (("jax", jhttp), ("torch", thttp)):
        ws = mod.PathwayWebserver(host="127.0.0.1", port=0, **kwargs)
        register(ws)
        ws.start()
        assert ws.port, f"{side} server did not bind"
        bases[side] = f"http://127.0.0.1:{ws.port}"
        if side == "torch":
            tws = ws
    return bases, tws


@pytest.fixture(scope="module")
def servers():
    def register(ws):
        ws.register("/custom", ("POST",), _echo, None, format="custom")
        ws.register("/raw", ("POST", "GET"), _echo, None, format="raw")
        ws.register("/boom", ("POST",), _boom, None)

    bases, tws = _servers(register, with_schema_endpoint=True)
    yield bases
    tws.stop()
    assert tws._thread is None


JSON = {"Content-Type": "application/json"}


def test_custom_format_parses_json_and_merges_params(servers):
    status, _, body, _ = _same(servers, "/custom?extra=1", "POST",
                               b'{"query": "hi"}', JSON)
    assert status == 200
    assert json.loads(body)["got"] == {"query": "hi", "extra": "1"}


def test_custom_format_unparseable_body_yields_empty_payload(servers):
    status, _, body, _ = _same(servers, "/custom", "POST", b"not json at all",
                               JSON)
    assert (status, json.loads(body)["got"]) == (200, {})


def test_raw_format_takes_body_as_query(servers):
    status, ctype, body, _ = _same(servers, "/raw", "POST",
                                   b"plain text question", JSON)
    assert status == 200 and ctype.startswith("application/json")
    assert json.loads(body)["got"] == {"query": "plain text question"}


def test_raw_format_applies_to_every_method(servers):
    status, _, body, _ = _same(servers, "/raw?ignored=1")
    assert (status, json.loads(body)["got"]) == (200, {"query": ""})


def test_unknown_route_is_404(servers):
    status, ctype, body, _ = _same(servers, "/nowhere", "POST", b"{}", JSON)
    assert (status, body) == (404, "no such route")
    assert ctype.startswith("text/plain")


def test_handler_error_is_500_with_its_repr(servers):
    status, _, body, hdrs = _same(servers, "/boom", "POST", b"{}", JSON)
    assert (status, body) == (500, "ValueError('boom')")
    assert hdrs["X-Pathway-Request-Id"]


def test_request_id_adopted_or_minted(servers):
    _, _, _, hdrs = _same(servers, "/custom", "POST", b"{}",
                          {**JSON, "X-Pathway-Request-Id": "client-42"})
    assert hdrs["X-Pathway-Request-Id"] == "client-42"
    _, _, _, hdrs = _same(servers, "/custom", "POST", b"{}",
                          {**JSON, "X-Pathway-Request-Id": "bad id!"})
    assert hdrs["X-Pathway-Request-Id"] not in ("", "bad id!")


def test_schema_endpoint_yaml_default_and_json(servers):
    status, ctype, value, _ = _same(servers, "/_schema", parse=yaml.safe_load)
    assert status == 200 and ctype.startswith("text/x-yaml")
    assert value["openapi"] == "3.0.3"
    status, _, value, _ = _same(servers, "/_schema?format=json",
                                parse=json.loads)
    assert status == 200 and value["openapi"]
    status, _, body, _ = _same(servers, "/_schema?format=xml")
    assert status == 400 and "Unknown format" in body


def test_schema_endpoint_describes_registered_routes():
    import pathway_tpu.internals.schema as jsch
    import pathway_tpu_torch.internals.schema as tsch

    def register(ws):
        sch = jsch if isinstance(ws, jhttp.PathwayWebserver) else tsch
        schema = sch.schema_from_types(query=str, k=int, w=float, b=bool)
        ws.register("/q", ("GET", "POST"), _echo, schema)
        ws.register("/empty", ("POST",), _echo, sch.schema_from_types())

    bases, tws = _servers(register)
    try:
        _, _, value, _ = _same(bases, "/_schema", parse=yaml.safe_load)
        props = value["paths"]["/q"]["post"]["requestBody"]["content"][
            "application/json"]["schema"]["properties"]
        assert props == {"query": {"type": "string"},
                         "k": {"type": "integer"}, "w": {"type": "number"},
                         "b": {"type": "boolean"}}
        _same(bases, "/_schema?format=json", parse=json.loads)
    finally:
        tws.stop()


def test_formats_are_keyed_per_method():
    def register(ws):
        ws.register("/mixed", ("POST",), _echo, None, format="raw")
        ws.register("/mixed", ("GET",), _echo, None, format="custom")

    bases, tws = _servers(register)
    try:
        status, _, body, _ = _same(bases, "/mixed", "POST", b"plain text",
                                   JSON)
        assert (status, json.loads(body)["got"]) == (
            200, {"query": "plain text"})
        _, _, body, _ = _same(bases, "/mixed?q=1")
        assert json.loads(body)["got"] == {"q": "1"}
    finally:
        tws.stop()


def test_cors_headers_and_preflight():
    def register(ws):
        ws.register("/c", ("POST",), _echo, None)

    bases, tws = _servers(register, with_cors=True)
    try:
        status, _, _, hdrs = _same(bases, "/c", "OPTIONS")
        assert status == 204
        assert hdrs["Access-Control-Allow-Origin"] == "*"
        status, _, _, hdrs = _same(bases, "/c", "POST", b"{}")
        assert status == 200
        assert hdrs["Access-Control-Allow-Origin"] == "*"
    finally:
        tws.stop()


@pytest.mark.parametrize("mod", [jhttp, thttp], ids=["jax", "torch"])
def test_conflicting_format_reregistration_is_rejected(mod):
    ws = mod.PathwayWebserver(host="127.0.0.1", port=0)
    ws.register("/r", ("POST",), _echo, None, format="raw")
    with pytest.raises(ValueError, match="already registered"):
        ws.register("/r", ("POST",), _echo, None, format="custom")
    ws.register("/r", ("POST",), _echo, None, format="raw")


@pytest.mark.parametrize("mod", [jhttp, thttp], ids=["jax", "torch"])
def test_rejected_reregistration_is_atomic(mod):
    async def h1(payload):
        return {"h": 1}

    async def h2(payload):
        return {"h": 2}

    ws = mod.PathwayWebserver(host="127.0.0.1", port=0)
    ws.register("/r", ("POST",), h1, None, format="raw")
    with pytest.raises(ValueError, match="already registered"):
        ws.register("/r", ("GET", "POST"), h2, None, format="custom")
    assert ("GET", "/r") not in ws._routes
    assert ws._routes[("POST", "/r")] is h1
    assert ws._formats[("POST", "/r")] == "raw"


def test_rest_connector_infers_and_validates_format():
    import pathway_tpu_torch.internals.schema as sch
    from pathway_tpu_torch.internals.parse_graph import G

    G.clear()
    ws = thttp.PathwayWebserver(host="127.0.0.1", port=0)
    table, _ = thttp.rest_connector(webserver=ws, route="/infer")
    assert table._plan.params["datasource"].format == "raw"
    assert table.column_names() == ["query"]
    table2, _ = thttp.rest_connector(
        webserver=ws, route="/infer2",
        schema=sch.schema_from_types(question=str))
    assert table2._plan.params["datasource"].format == "custom"
    with pytest.raises(ValueError, match="unknown endpoint input format"):
        thttp.rest_connector(webserver=ws,
                             schema=sch.schema_from_types(query=str),
                             format="yaml")
    with pytest.raises(ValueError, match="requires a 'query' column"):
        thttp.rest_connector(webserver=ws,
                             schema=sch.schema_from_types(text=str),
                             format="raw")
    for kwargs in ({"persistent_id": "q"}, {"durable_ack": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            thttp.rest_connector(webserver=ws, route="/p", **kwargs)
    G.clear()


def test_bind_failure_raises_and_stop_is_idempotent():
    ws = thttp.PathwayWebserver(host="127.0.0.1", port=0)
    ws.start()
    taken = thttp.PathwayWebserver(host="127.0.0.1", port=ws.port)
    with pytest.raises(OSError):
        taken.start()
    ws.stop()
    ws.stop()
    taken.stop()


def _serve_pipeline(side: str, requests: list, **run_kwargs):
    """A rest_connector pipeline (schema query: str, k: int = 3; the
    answer ``{"upper": ..., "k": ...}``) under each package's pw.run on a
    thread; sends ``requests`` and returns the replies (status, body).
    Stops the run in a finally and fails if its thread outlives the
    join."""
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
        from pathway_tpu.internals.parse_graph import G
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals.parse_graph import G

    class Q(pw.Schema):
        query: str
        k: int = pw.column_definition(default_value=3)

    G.clear()
    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=0)
    queries, writer = pw.io.http.rest_connector(
        webserver=ws, route="/q", schema=Q, methods=("POST", "GET"),
        delete_completed_queries=True, autocommit_duration_ms=5)
    writer(queries.select(
        upper=pw.apply(lambda s: s.upper(), queries.query), k=queries.k))
    errors = []

    def run():
        try:
            pw.run(**run_kwargs)
        except Exception as e:  # re-raised below
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    out = []
    try:
        deadline = time.monotonic() + DEADLINE_S
        while not (ws._started.is_set() and ws.port) and not errors:
            assert time.monotonic() < deadline, "server never started"
            time.sleep(0.01)
        base = f"http://127.0.0.1:{ws.port}"
        for path, method, body in requests:
            status, _, text = _send(base, path, method, body, JSON)
            out.append((status, text))
    finally:
        streaming.stop_all()
        th.join(DEADLINE_S)
        G.clear()
    assert not th.is_alive(), f"{side} run outlived stop_all()"
    assert not errors, errors
    return out


def test_rest_connector_pipeline_statuses_and_bodies_equal():
    requests = [("/q", "POST", b'{"query": "hi", "k": 5}'),
                ("/q", "POST", b'{"query": "default k"}'),
                ("/q", "POST", b'{"k": 1}'),
                ("/q?query=from%20params", "POST", b"{}"),
                ("/q?query=get", "GET", None),
                ("/nowhere", "POST", b"{}")]
    jax = _serve_pipeline("jax", requests)
    port = _serve_pipeline("torch", requests)
    assert port == jax
    assert [s for s, _ in port] == [200, 200, 400, 200, 200, 404]
    assert json.loads(port[0][1]) == {"upper": "HI", "k": 5}
    assert json.loads(port[1][1]) == {"upper": "DEFAULT K", "k": 3}
    assert port[2][1] == "field 'query' is required"


def test_request_spans_join_the_trace(tmp_path):
    """With a trace path the recorder's request tracker stamps every
    query, and the written trace carries each request as an async span
    with its stages on a third track."""
    path = tmp_path / "trace.json"
    replies = _serve_pipeline("torch", [("/q", "POST", b'{"query": "a"}'),
                                        ("/q", "POST", b'{"query": "b"}')],
                              trace_path=str(path))
    assert [status for status, _ in replies] == [200, 200]
    events = json.loads(path.read_text())["traceEvents"]
    reqs = [e for e in events if e.get("cat") == "request"]
    begins = [e for e in reqs if e["ph"] == "b" and e["name"].startswith("req ")]
    assert len(begins) == 2
    for e in begins:
        assert e["tid"] == 2 and e["args"]["route"] == "/q"
        stages = {k[:-3]: v for k, v in e["args"].items()
                  if k.endswith("_ms") and k != "e2e_ms"}
        assert sum(stages.values()) == pytest.approx(e["args"]["e2e_ms"],
                                                     abs=0.01)
