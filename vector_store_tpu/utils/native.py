"""ctypes bindings for the native C++ components (native/*.cpp).

Provides:
  * HnswBaseline — clean-room CPU HNSW, the "usearch-CPU" benchmark
    anchor (BASELINE.md: anchor numbers must be measured locally);
  * read_fvecs / read_ivecs — native parsers for the SIFT-format
    datasets;
  * NativeKeyMap — u64-hash key⇄slot bimap for the ingest hot path.

The library is optional: `available()` gates use, and `build()` invokes
make.  Pure-Python fallbacks exist for the keymap (engine/keymap.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvst_native.so")

_lib: Optional[ctypes.CDLL] = None

_METRICS = {"l2": 0, "cosine": 1, "dot": 2}


def build() -> bool:
    """Compile the native library (make -C native)."""
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR], check=True, capture_output=True
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_create.argtypes = [ctypes.c_int] * 4
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_add.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.hnsw_search.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.hnsw_remove.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hnsw_size.restype = ctypes.c_long
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.fvecs_read.restype = ctypes.c_long
    lib.fvecs_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ivecs_read.restype = ctypes.c_long
    lib.ivecs_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.keymap_create.restype = ctypes.c_void_p
    lib.keymap_free.argtypes = [ctypes.c_void_p]
    lib.keymap_bind.restype = ctypes.c_int32
    lib.keymap_bind.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32]
    lib.keymap_unbind.restype = ctypes.c_int32
    lib.keymap_unbind.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.keymap_slot_of.restype = ctypes.c_int32
    lib.keymap_slot_of.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.keymap_key_of.restype = ctypes.c_int
    lib.keymap_key_of.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.keymap_len.restype = ctypes.c_long
    lib.keymap_len.argtypes = [ctypes.c_void_p]
    lib.keymap_bind_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.json_parse_floats.restype = ctypes.c_long
    lib.json_parse_floats.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    lib.json_parse_int.restype = ctypes.c_long
    lib.json_parse_int.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------


class HnswBaseline:
    """CPU HNSW (native/hnsw.cpp) — the usearch-CPU role for benchmarks."""

    def __init__(
        self,
        dims: int,
        m: int = 16,
        ef_construction: int = 128,
        space: str = "cosine",
    ) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.dims = dims
        self._h = lib.hnsw_create(dims, m, ef_construction, _METRICS[space])

    def add(self, vectors: np.ndarray) -> None:
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        self._lib.hnsw_add(
            self._h,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            v.shape[0] if v.ndim == 2 else 1,
        )

    def search(
        self, queries: np.ndarray, k: int, ef: int = 64
    ) -> tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        ids = np.full((nq, k), -1, dtype=np.int32)
        dists = np.full((nq, k), np.inf, dtype=np.float32)
        counts = np.zeros((nq,), dtype=np.int32)
        self._lib.hnsw_search(
            self._h,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nq,
            k,
            ef,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return dists, ids

    def remove(self, node_id: int) -> None:
        self._lib.hnsw_remove(self._h, int(node_id))

    def __len__(self) -> int:
        return self._lib.hnsw_size(self._h)

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.hnsw_free(self._h)
            self._h = None


def read_fvecs(path: str, max_rows: int, dims_hint: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = np.empty((max_rows, dims_hint), dtype=np.float32)
    dims = ctypes.c_int(0)
    rows = lib.fvecs_read(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows,
        ctypes.byref(dims),
    )
    if rows < 0:
        raise IOError(f"fvecs_read({path}) failed: {rows}")
    if dims.value != dims_hint:
        # re-interpret with true dims
        flat = buf.reshape(-1)[: rows * dims.value]
        return flat.reshape(rows, dims.value).copy()
    return buf[:rows]


def read_ivecs(path: str, max_rows: int, dims_hint: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = np.empty((max_rows, dims_hint), dtype=np.int32)
    dims = ctypes.c_int(0)
    rows = lib.ivecs_read(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_rows,
        ctypes.byref(dims),
    )
    if rows < 0:
        raise IOError(f"ivecs_read({path}) failed: {rows}")
    if dims.value != dims_hint:
        flat = buf.reshape(-1)[: rows * dims.value]
        return flat.reshape(rows, dims.value).copy()
    return buf[:rows]


class NativeKeyMap:
    """u64-hashed key⇄slot bimap backed by native/io.cpp."""

    def __init__(self) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._m = lib.keymap_create()

    def bind(self, key: int, slot: int) -> int:
        return self._lib.keymap_bind(self._m, key, slot)

    def bind_batch(self, keys: np.ndarray, slots: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        out = np.empty_like(slots)
        self._lib.keymap_bind_batch(
            self._m,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(keys),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def unbind(self, key: int) -> int:
        return self._lib.keymap_unbind(self._m, key)

    def slot_of(self, key: int) -> int:
        return self._lib.keymap_slot_of(self._m, key)

    def key_of(self, slot: int) -> Optional[int]:
        out = ctypes.c_uint64(0)
        if self._lib.keymap_key_of(self._m, slot, ctypes.byref(out)):
            return out.value
        return None

    def __len__(self) -> int:
        return self._lib.keymap_len(self._m)

    def __del__(self) -> None:
        if getattr(self, "_m", None):
            self._lib.keymap_free(self._m)
            self._m = None


# ---------------------------------------------------------------------------
# Serving-path JSON fast scanners (native/fastjson.cpp).  Python's json
# module's parse of one 768-d embedding body is a large share of a
# single-process server's per-request host time.  These parse the
# PostIndexAnnRequest hot fields directly, with a guaranteed fall-back
# (return None) to json.loads on any structural surprise.


def parse_json_floats(body: bytes, key: bytes, cap: int) -> Optional[np.ndarray]:
    """`"<key>": [floats]` out of a raw JSON body, or None (caller must
    fall back to a full JSON parse — absent key, >cap values, or any
    structural surprise)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(cap, dtype=np.float32)
    n = lib.json_parse_floats(
        body,
        len(body),
        b'"' + key + b'"',
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap,
    )
    if n < 0:
        return None
    return out[:n]


def parse_json_int(body: bytes, key: bytes, default: int) -> Optional[int]:
    """`"<key>": <int>` out of a raw JSON body; `default` when the key is
    absent; None on a malformed value (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    v = lib.json_parse_int(body, len(body), b'"' + key + b'"', default)
    return None if v < 0 else int(v)
