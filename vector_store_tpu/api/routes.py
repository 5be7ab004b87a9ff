"""REST routes — both API surfaces of the reference, one router.

Text-search surface (live system, reference src/httproutes.rs):
    GET  /api/v1/text-search                     list text indexes   (:53-63)
    PUT  /api/v1/text-search/{index}             create (del+add)    (:65-79)
    POST /api/v1/text-search/{index}/add         {id, text} → 200/404 (:99-110)
    POST /api/v1/text-search/{index}/search      {text, limit} → keys | 404 | 500 (:132-150)

ANN surface (vestigial system, shapes from tests/integration/httpclient.rs):
    GET  /api/v1/indexes                          list ids            (:35-44)
    POST /api/v1/indexes/{ks}/{idx}/ann           {embedding, limit} →
         {primary_keys: {col: [...]}, distances: [...]}               (:46-66)
    GET  /api/v1/indexes/{ks}/{idx}/count         live count          (:68-80)

Extensions (absent in the reference, needed for standalone use — the
reference only created ANN indexes via DB schema discovery):
    PUT    /api/v1/indexes/{ks}/{idx}             create with params body
    DELETE /api/v1/indexes/{ks}/{idx}             drop
    POST   /api/v1/indexes/{ks}/{idx}/add         {primary_key, embedding}
    POST   /api/v1/indexes/{ks}/{idx}/remove      {primary_key}
    GET    /healthz

Plus OpenAPI JSON at /api-docs/openapi.json and a Swagger UI page at
/swagger-ui (reference: httproutes.rs:50).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

import numpy as np
from aiohttp import web

from ..utils import native as _native

from ..engine.engine import EngineHandle
from ..types import IndexId, IndexMetadata, IndexParams, Limit
from ..utils import metrics
from .openapi import openapi_spec, swagger_html

log = logging.getLogger("vst.http")

# Optional serving deadline (seconds) for query requests: a wedged
# device dispatch surfaces as 504 instead of a connection that hangs
# forever.  Off by default (0) — first compiles of a new dispatch shape
# legitimately take tens of seconds, so deployments opt in once warm.
REQUEST_TIMEOUT_S = float(os.environ.get("VST_REQUEST_TIMEOUT_S", "0"))


class _DeadlineExceeded(Exception):
    """Distinct from TimeoutError so (a) pre-3.11 asyncio.TimeoutError is
    caught reliably and (b) a TimeoutError raised inside a handler is
    never mislabeled as the serving deadline."""


async def _bounded(coro):
    timeout = REQUEST_TIMEOUT_S
    if timeout <= 0:
        return await coro
    try:
        return await asyncio.wait_for(coro, timeout)
    except asyncio.TimeoutError:
        raise _DeadlineExceeded from None


def _json_error(status: int, text: str = "") -> web.Response:
    return web.Response(status=status, text=text)


async def _get_index(request: web.Request, index_id: IndexId):
    # Handle cache: the engine registry changes only on add/del index,
    # and del CLOSES the handle (the reference's handle-drop semantics),
    # so `closed` doubles as the invalidation bit — a mailbox roundtrip
    # per request would otherwise cost the single-core serving path ~5-10%
    # plus a scheduling turn.
    cache: dict = request.app["handle_cache"]
    h = cache.get(index_id)
    if h is not None and not h.closed:
        return h
    engine: EngineHandle = request.app["engine"]
    h = await engine.get_index(index_id)
    if h is None:
        cache.pop(index_id, None)
    else:
        cache[index_id] = h
    return h


def _index_id(request: web.Request) -> IndexId:
    if "keyspace" in request.match_info:
        return IndexId.from_parts(
            request.match_info["keyspace"], request.match_info["index"]
        )
    return IndexId(request.match_info["index"])


# --------------------------------------------------------------------------
# text-search surface


async def get_text_indexes(request: web.Request) -> web.Response:
    engine: EngineHandle = request.app["engine"]
    ids = []
    for index_id in await engine.get_index_ids():
        handle = await engine.get_index(index_id)
        if handle is not None and getattr(handle.metadata, "kind", "text") == "text":
            ids.append(index_id.value)
    return web.json_response(ids)


async def put_text_index(request: web.Request) -> web.Response:
    """Create an index — recreate semantics: del then add
    (httproutes.rs:76-79)."""
    engine: EngineHandle = request.app["engine"]
    index_id = _index_id(request)
    await engine.del_index(index_id)
    await engine.add_index(IndexMetadata(index_id=index_id, kind="text"))
    return web.Response(status=200)


async def post_text_add(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    try:
        await index.add((body["id"],), body["text"])
    except Exception as exc:  # noqa: BLE001 — e.g. handle closed by a
        # racing PUT recreate; keep the JSON 500 body, not aiohttp's
        # default error page
        return _json_error(500, f"index.add request error: {exc}")
    return web.Response(status=200)


async def post_text_search(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    limit = Limit(int(body.get("limit", 1)))
    try:
        keys = await _bounded(index.search(body["text"], limit))
    except _DeadlineExceeded:
        return _json_error(504, "search deadline exceeded")
    except Exception as exc:  # noqa: BLE001 — 500 with error text
        msg = f"index.search request error: {exc}"
        log.debug("post_text_search: %s", msg)
        return _json_error(500, msg)
    # live system keys are plain strings (lib.rs:63); unwrap 1-tuples
    return web.json_response([k[0] if len(k) == 1 else list(k) for k in keys])


# --------------------------------------------------------------------------
# ANN surface


async def get_ann_indexes(request: web.Request) -> web.Response:
    engine: EngineHandle = request.app["engine"]
    ids = []
    for index_id in await engine.get_index_ids():
        handle = await engine.get_index(index_id)
        if handle is not None and getattr(handle.metadata, "kind", "ann") != "text":
            ids.append(index_id.value)
    return web.json_response(ids)


async def put_ann_index(request: web.Request) -> web.Response:
    engine: EngineHandle = request.app["engine"]
    index_id = _index_id(request)
    body = await request.json() if request.can_read_body else {}
    try:
        params = IndexParams(
            dimensions=int(body["dimensions"]),
            connectivity=int(body.get("connectivity", 32)),
            expansion_add=int(body.get("expansion_add", 128)),
            expansion_search=int(body.get("expansion_search", 64)),
            space=body.get("space", "cosine"),
            dtype=body.get("dtype", "bfloat16" ),
        )
    except KeyError:
        return _json_error(400, "missing required field: dimensions")
    except ValueError as exc:
        return _json_error(400, str(exc))
    kind = body.get("kind", "ann")
    key_columns = tuple(body.get("key_columns", ()))
    await engine.del_index(index_id)
    await engine.add_index(
        IndexMetadata(
            index_id=index_id, params=params, key_columns=key_columns, kind=kind
        )
    )
    return web.Response(status=200)


async def get_ann_index_info(request: web.Request) -> web.Response:
    """Index introspection (extension): kind, params, live count."""
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    meta = index.metadata
    params = getattr(meta, "params", None)
    return web.json_response(
        {
            "id": _index_id(request).value,
            "kind": getattr(meta, "kind", "ann"),
            "key_columns": list(getattr(meta, "key_columns", ()) or ()),
            "params": {
                "dimensions": params.dimensions,
                "connectivity": params.connectivity,
                "expansion_add": params.expansion_add,
                "expansion_search": params.expansion_search,
                "space": params.space,
                "dtype": params.dtype,
            }
            if params is not None
            else None,
            "count": await index.count(),
        }
    )


async def delete_ann_index(request: web.Request) -> web.Response:
    engine: EngineHandle = request.app["engine"]
    await engine.del_index(_index_id(request))
    return web.Response(status=200)


def _column_major(keys: list, key_columns: tuple) -> dict:
    """PostIndexAnnResponse.primary_keys shape: {column: [values]}
    (httpclient.rs:46-66)."""
    width = max((len(k) for k in keys), default=len(key_columns) or 1)
    cols = list(key_columns) + [
        f"pk{i}" for i in range(len(key_columns), width)
    ]
    return {
        col: [list(k)[i] if i < len(k) else None for k in keys]
        for i, col in enumerate(cols[:width])
    }


async def post_ann(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    # Hot path: the native scanner parses the two fields of
    # PostIndexAnnRequest straight off the raw body (json.loads of a
    # 768-d body is a large share of the per-request host time).
    # Any structural surprise returns None and the full JSON parse below
    # keeps its exact error semantics.
    raw = await request.read()
    embedding = _native.parse_json_floats(raw, b"embedding", 8192)
    lim = _native.parse_json_int(raw, b"limit", 1)
    if embedding is not None and len(embedding) and lim is not None and lim > 0:
        limit = Limit(lim)
    else:
        body = json.loads(raw)
        limit = Limit(int(body.get("limit", 1)))
        embedding = np.asarray(body["embedding"], dtype=np.float32)
    try:
        keys, distances = await _bounded(index.ann(embedding, limit))
    except _DeadlineExceeded:
        return _json_error(504, "ann deadline exceeded")
    except ValueError as exc:  # dimension mismatch (usearch.rs:259-272)
        return _json_error(400, str(exc))
    except Exception as exc:  # noqa: BLE001
        msg = f"index.ann request error: {exc}"
        log.debug("post_ann: %s", msg)
        return _json_error(500, msg)
    key_columns = tuple(getattr(index.metadata, "key_columns", ()) or ())
    return web.json_response(
        {"primary_keys": _column_major(keys, key_columns), "distances": distances}
    )


async def get_count(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    try:
        return web.json_response(await index.count())
    except Exception as exc:  # noqa: BLE001 — e.g. racing recreate
        return _json_error(500, f"index.count request error: {exc}")


def _primary_key(raw, index) -> tuple:
    """Normalize a JSON primary key into a hashable tuple.

    Accepts a scalar, a list of scalars, or an object (column → value;
    ordered by the index's key_columns when declared, else by JSON field
    order).  Rejects nested containers — they would poison the keymap.
    """
    if isinstance(raw, dict):
        key_columns = tuple(getattr(index.metadata, "key_columns", ()) or ())
        if key_columns:
            missing = [c for c in key_columns if c not in raw]
            if missing:
                raise ValueError(f"primary_key missing columns: {missing}")
            values = [raw[c] for c in key_columns]
        else:
            values = list(raw.values())
    elif isinstance(raw, list):
        values = raw
    else:
        values = [raw]
    for v in values:
        if not isinstance(v, (str, int, float, bool)) and v is not None:
            raise ValueError(
                f"primary_key values must be scalars, got {type(v).__name__}"
            )
    return tuple(values)


async def post_ann_add(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    embedding = np.asarray(body["embedding"], dtype=np.float32)
    try:
        key = _primary_key(body["primary_key"], index)
        # the actor's AddOrReplace is fire-and-forget (parity with
        # usearch.rs:148-153, no ack channel), so a dims mismatch there
        # would only be logged — reject it here while the client is
        # still listening
        dims = getattr(getattr(index.metadata, "params", None), "dimensions", None)
        if dims is not None and embedding.shape != (dims,):
            raise ValueError(
                f"expected embedding of {dims} dimensions, "
                f"got shape {embedding.shape}"
            )
        await index.add_or_replace(key, embedding)
    except ValueError as exc:
        return _json_error(400, str(exc))
    except Exception as exc:  # noqa: BLE001 — e.g. racing recreate
        return _json_error(500, f"index.add request error: {exc}")
    return web.Response(status=200)


async def post_ann_remove(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    body = await request.json()
    try:
        key = _primary_key(body["primary_key"], index)
    except ValueError as exc:
        return _json_error(400, str(exc))
    try:
        await index.remove(key)
    except Exception as exc:  # noqa: BLE001 — e.g. racing recreate
        return _json_error(500, f"index.remove request error: {exc}")
    return web.Response(status=200)


# --------------------------------------------------------------------------


async def post_compact(request: web.Request) -> web.Response:
    index = await _get_index(request, _index_id(request))
    if index is None:
        return _json_error(404)
    try:
        count = await index.compact()
    except Exception as exc:  # noqa: BLE001
        return _json_error(500, f"compact error: {exc}")
    return web.json_response({"count": count})


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def get_metrics(request: web.Request) -> web.Response:
    """Prometheus text exposition (beyond the reference, which has no
    metrics surface at all — SURVEY §5)."""
    return web.Response(text=metrics.render(), content_type="text/plain")


@web.middleware
async def _metrics_middleware(request: web.Request, handler):
    t0 = time.time()
    status = 500
    try:
        resp = await handler(request)
        status = resp.status
        return resp
    except web.HTTPException as exc:
        status = exc.status
        raise
    finally:
        # unmatched requests (404 scanners, random probes) collapse to
        # one sentinel label — raw paths would mint a new Prometheus
        # series per distinct URL and grow the registry without bound
        route = (
            request.match_info.route.resource.canonical
            if request.match_info.route.resource is not None
            else "unmatched"
        )
        if route not in ("/metrics", "/healthz"):
            metrics.counter(
                "vst_http_requests_total",
                method=request.method,
                route=route,
                status=str(status),
            ).inc()
            metrics.histogram(
                "vst_http_request_seconds", method=request.method, route=route
            ).observe(time.time() - t0)


@web.middleware
async def _reject_malformed_middleware(request: web.Request, handler):
    """Backstop for garbage request bodies — the role axum's extractor
    layer plays in the reference (malformed JSON never reaches an
    httproutes.rs handler).  Parse/shape errors (unparseable JSON,
    missing fields, wrong value types) become a 400 with the error
    text; anything else uncaught becomes a structured 500 instead of
    aiohttp's default HTML error page."""
    import json as _json

    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except (
        _json.JSONDecodeError,
        UnicodeDecodeError,
        KeyError,
        TypeError,
        ValueError,
    ) as exc:
        return _json_error(400, f"malformed request: {exc!r}")
    except Exception as exc:  # noqa: BLE001
        log.exception("unhandled route error")
        return _json_error(500, f"internal error: {exc}")


async def get_openapi(request: web.Request) -> web.Response:
    return web.json_response(openapi_spec())


async def get_swagger(request: web.Request) -> web.Response:
    return web.Response(text=swagger_html(), content_type="text/html")


def build_app(engine: EngineHandle) -> web.Application:
    app = web.Application(
        middlewares=[_metrics_middleware, _reject_malformed_middleware]
    )
    app["engine"] = engine
    app["handle_cache"] = {}
    app.add_routes(
        [
            web.get("/api/v1/text-search", get_text_indexes),
            web.put("/api/v1/text-search/{index}", put_text_index),
            web.post("/api/v1/text-search/{index}/add", post_text_add),
            web.post("/api/v1/text-search/{index}/search", post_text_search),
            web.get("/api/v1/indexes", get_ann_indexes),
            web.put("/api/v1/indexes/{keyspace}/{index}", put_ann_index),
            web.get("/api/v1/indexes/{keyspace}/{index}", get_ann_index_info),
            web.delete("/api/v1/indexes/{keyspace}/{index}", delete_ann_index),
            web.post("/api/v1/indexes/{keyspace}/{index}/ann", post_ann),
            web.get("/api/v1/indexes/{keyspace}/{index}/count", get_count),
            web.post("/api/v1/indexes/{keyspace}/{index}/add", post_ann_add),
            web.post("/api/v1/indexes/{keyspace}/{index}/remove", post_ann_remove),
            web.post("/api/v1/indexes/{keyspace}/{index}/compact", post_compact),
            web.get("/healthz", healthz),
            web.get("/metrics", get_metrics),
            web.get("/api-docs/openapi.json", get_openapi),
            web.get("/swagger-ui", get_swagger),
        ]
    )
    return app
