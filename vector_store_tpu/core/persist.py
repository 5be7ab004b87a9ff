"""Index persistence — checkpoint/restore of the device graph.

The reference has **no** persistence: indexes are memory-only and rebuilt
from the source of truth on every (re)create (SURVEY §5; reference
src/httproutes.rs:76-79 recreate, src/db_index.rs:104-130 full rescan).
Rebuild-from-source remains the parity behaviour; this module closes the
gap the reference left open — snapshotting the device-resident graph
(vectors + adjacency + liveness) plus the host-side key map to one
``.npz`` so a large index restarts in seconds instead of re-scanning.
"""

from __future__ import annotations

import json
from dataclasses import asdict
from typing import Optional

import jax.numpy as jnp
import numpy as np
from ..utils.persistio import atomic_savez_compressed

from ..types import IndexParams
from .graph import GraphConfig, GraphState
from .index import SlotIndex

FORMAT_VERSION = 1


def save(path: str, index: SlotIndex, keymap_blob: Optional[dict] = None) -> None:
    """Snapshot a SlotIndex (and optionally the engine's key map) to npz.

    Holds the index lock for the whole snapshot: insert donates the
    previous state buffers to XLA, so an unlocked read during live
    ingest can touch deleted arrays or tear frontier vs. bank."""
    with index._lock:
        _save_locked(path, index, keymap_blob)


def _save_locked(
    path: str, index: SlotIndex, keymap_blob: Optional[dict]
) -> None:
    state = index._state
    meta = {
        "format": FORMAT_VERSION,
        "params": asdict(index.params),
        "cfg": asdict(index.cfg),
        "exact": index._exact,
        "insert_block": index.insert_block,
    }
    # int8 banks snapshot in their native byte width (a cast to f32 would
    # quadruple the file); bf16 has no portable npz encoding, so it rides
    # as f32 and re-narrows on load.
    vectors = (
        np.asarray(state.vectors)
        if index.cfg.quantized
        else np.asarray(state.vectors.astype(jnp.float32))
    )
    atomic_savez_compressed(
        path,
        vectors=vectors,
        scales=np.asarray(state.scales),
        neighbors=np.asarray(state.neighbors),
        nbr_dist=np.asarray(state.nbr_dist),
        valid=np.asarray(state.valid),
        size=np.asarray(state.size),
        frontier=np.asarray(state.frontier),
        route_centroids=np.asarray(state.route_centroids.astype(jnp.float32)),
        route_members=np.asarray(state.route_members),
        route_cnt=np.asarray(state.route_cnt),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        keymap=np.frombuffer(
            json.dumps(keymap_blob or {}).encode(), dtype=np.uint8
        ),
    )


def load(path: str) -> tuple[SlotIndex, dict]:
    """Restore a SlotIndex; returns (index, keymap_blob)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["format"] != FORMAT_VERSION:
            raise ValueError(f"unsupported snapshot format {meta['format']}")
        params = IndexParams(**meta["params"])
        cfg = GraphConfig.from_meta(meta["cfg"])
        exact = meta.get("exact", False)
        # older snapshots predate the insert_block field: re-derive the
        # block size SlotIndex.__init__ would have chosen for the mode
        insert_block = meta.get("insert_block", 4096 if exact else 256)
        if "route_centroids" in z.files:
            rc = jnp.asarray(z["route_centroids"]).astype(cfg.compute_dtype)
            rm = jnp.asarray(z["route_members"])
            rn = jnp.asarray(z["route_cnt"])
        else:  # pre-router snapshot: dummy arrays, flat routing
            from .graph import init_router

            cfg = GraphConfig.from_meta(meta["cfg"], route_k=0)
            rc, rm, rn = init_router(cfg)
        state = GraphState(
            vectors=jnp.asarray(z["vectors"]).astype(cfg.jdtype),
            scales=jnp.asarray(z["scales"]),
            neighbors=jnp.asarray(z["neighbors"]),
            nbr_dist=jnp.asarray(z["nbr_dist"]),
            valid=jnp.asarray(z["valid"]),
            size=jnp.asarray(z["size"]),
            frontier=jnp.asarray(z["frontier"]),
            route_centroids=rc,
            route_members=rm,
            route_cnt=rn,
        )
        index = SlotIndex.restore(params, cfg, state, exact, insert_block)
        keymap_blob = json.loads(bytes(z["keymap"]).decode())
    return index, keymap_blob
