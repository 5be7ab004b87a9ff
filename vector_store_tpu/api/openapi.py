"""OpenAPI document + Swagger UI page.

The reference generates its spec with utoipa and serves Swagger UI at
/swagger-ui (src/httproutes.rs:28-51).  Here the spec is a hand-rolled
OpenAPI 3.0 document covering both surfaces; the UI page loads the
swagger-ui assets from a CDN (served HTML only — works when the client
has egress; the JSON spec itself is always available).
"""

from __future__ import annotations


def _index_param(name: str, desc: str) -> dict:
    return {
        "name": name,
        "in": "path",
        "required": True,
        "schema": {"type": "string"},
        "description": desc,
    }


def openapi_spec() -> dict:
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "vector-store-tpu",
            "description": "Vector & text search service on an accelerator",
            "version": "0.1.0",
        },
        "tags": [
            {"name": "text-search", "description": "Full-text index API"},
            {"name": "indexes", "description": "ANN (vector) index API"},
        ],
        "paths": {
            "/api/v1/text-search": {
                "get": {
                    "tags": ["text-search"],
                    "description": "Get list of current indexes",
                    "responses": {"200": {"description": "List of indexes"}},
                }
            },
            "/api/v1/text-search/{index}": {
                "put": {
                    "tags": ["text-search"],
                    "description": "Create an index",
                    "parameters": [_index_param("index", "Index to create")],
                    "responses": {"200": {"description": "An Index created"}},
                }
            },
            "/api/v1/text-search/{index}/add": {
                "post": {
                    "tags": ["text-search"],
                    "description": "Add an item to the index",
                    "parameters": [_index_param("index", "Index to add")],
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "required": ["id", "text"],
                                    "properties": {
                                        "id": {"type": "string"},
                                        "text": {"type": "string"},
                                    },
                                }
                            }
                        }
                    },
                    "responses": {
                        "200": {"description": "Add done"},
                        "404": {"description": "Index not found"},
                    },
                }
            },
            "/api/v1/text-search/{index}/search": {
                "post": {
                    "tags": ["text-search"],
                    "description": "Search in the index",
                    "parameters": [_index_param("index", "Index to search")],
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "required": ["text"],
                                    "properties": {
                                        "text": {"type": "string"},
                                        "limit": {"type": "integer", "default": 1},
                                    },
                                }
                            }
                        }
                    },
                    "responses": {
                        "200": {"description": "Search result"},
                        "404": {"description": "Index not found"},
                    },
                }
            },
            "/api/v1/indexes": {
                "get": {
                    "tags": ["indexes"],
                    "description": "List ANN indexes",
                    "responses": {"200": {"description": "List of index ids"}},
                }
            },
            "/api/v1/indexes/{keyspace}/{index}": {
                "put": {
                    "tags": ["indexes"],
                    "description": "Create an ANN index",
                    "parameters": [
                        _index_param("keyspace", "Keyspace"),
                        _index_param("index", "Index name"),
                    ],
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "required": ["dimensions"],
                                    "properties": {
                                        "dimensions": {"type": "integer"},
                                        "connectivity": {"type": "integer"},
                                        "expansion_add": {"type": "integer"},
                                        "expansion_search": {"type": "integer"},
                                        "space": {
                                            "type": "string",
                                            "enum": ["cosine", "l2", "dot"],
                                        },
                                        "dtype": {"type": "string"},
                                        "key_columns": {
                                            "type": "array",
                                            "items": {"type": "string"},
                                        },
                                    },
                                }
                            }
                        }
                    },
                    "responses": {"200": {"description": "Created"}},
                },
                "delete": {
                    "tags": ["indexes"],
                    "description": "Drop an ANN index",
                    "parameters": [
                        _index_param("keyspace", "Keyspace"),
                        _index_param("index", "Index name"),
                    ],
                    "responses": {"200": {"description": "Dropped"}},
                },
            },
            "/api/v1/indexes/{keyspace}/{index}/ann": {
                "post": {
                    "tags": ["indexes"],
                    "description": "Nearest-neighbour search",
                    "parameters": [
                        _index_param("keyspace", "Keyspace"),
                        _index_param("index", "Index name"),
                    ],
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "required": ["embedding"],
                                    "properties": {
                                        "embedding": {
                                            "type": "array",
                                            "items": {"type": "number"},
                                        },
                                        "limit": {"type": "integer", "default": 1},
                                    },
                                }
                            }
                        }
                    },
                    "responses": {
                        "200": {
                            "description": "primary_keys (column-major) + distances"
                        },
                        "404": {"description": "Index not found"},
                    },
                }
            },
            "/api/v1/indexes/{keyspace}/{index}/count": {
                "get": {
                    "tags": ["indexes"],
                    "description": "Number of live items",
                    "parameters": [
                        _index_param("keyspace", "Keyspace"),
                        _index_param("index", "Index name"),
                    ],
                    "responses": {"200": {"description": "count"}},
                }
            },
            "/api/v1/indexes/{keyspace}/{index}/add": {
                "post": {
                    "tags": ["indexes"],
                    "description": "Upsert an embedding (acked)",
                    "parameters": [
                        _index_param("keyspace", "Keyspace"),
                        _index_param("index", "Index name"),
                    ],
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "required": ["primary_key", "embedding"],
                                    "properties": {
                                        "primary_key": {"type": "array"},
                                        "embedding": {
                                            "type": "array",
                                            "items": {"type": "number"},
                                        },
                                    },
                                }
                            }
                        }
                    },
                    "responses": {
                        "200": {"description": "Upserted"},
                        "404": {"description": "Index not found"},
                    },
                }
            },
            "/api/v1/indexes/{keyspace}/{index}/remove": {
                "post": {
                    "tags": ["indexes"],
                    "description": "Remove a primary key",
                    "parameters": [
                        _index_param("keyspace", "Keyspace"),
                        _index_param("index", "Index name"),
                    ],
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "required": ["primary_key"],
                                    "properties": {
                                        "primary_key": {"type": "array"}
                                    },
                                }
                            }
                        }
                    },
                    "responses": {
                        "200": {"description": "Removed"},
                        "404": {"description": "Index not found"},
                    },
                }
            },
            "/api/v1/indexes/{keyspace}/{index}/compact": {
                "post": {
                    "tags": ["indexes"],
                    "description": (
                        "Reclaim tombstoned rows (rebuild away deletions); "
                        "returns the live count"
                    ),
                    "parameters": [
                        _index_param("keyspace", "Keyspace"),
                        _index_param("index", "Index name"),
                    ],
                    "responses": {
                        "200": {
                            "description": "Compacted",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "type": "object",
                                        "properties": {
                                            "count": {"type": "integer"}
                                        },
                                    }
                                }
                            },
                        },
                        "404": {"description": "Index not found"},
                        "500": {"description": "Backend cannot compact"},
                    },
                }
            },
            "/healthz": {
                "get": {
                    "description": "Liveness probe",
                    "responses": {"200": {"description": "ok"}},
                }
            },
            "/metrics": {
                "get": {
                    "description": (
                        "Prometheus text exposition: HTTP request "
                        "counts/latency plus per-index query and upsert "
                        "counters"
                    ),
                    "responses": {"200": {"description": "metrics text"}},
                }
            },
        },
    }


def swagger_html() -> str:
    return """<!DOCTYPE html>
<html>
<head>
  <title>vector-store-tpu — Swagger UI</title>
  <link rel="stylesheet"
        href="https://unpkg.com/swagger-ui-dist@5/swagger-ui.css">
</head>
<body>
<div id="swagger-ui"></div>
<script src="https://unpkg.com/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
<script>
  window.onload = () => {
    SwaggerUIBundle({url: '/api-docs/openapi.json', dom_id: '#swagger-ui'});
  };
</script>
</body>
</html>
"""
