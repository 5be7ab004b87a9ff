"""Device-scored BM25 text index.

Replaces the OpenSearch/Lucene backend of the reference (src/index/
opensearch.rs:157-210) with a device-resident scorer: documents live in
device memory as fixed-shape *unique-term count* arrays and a whole
query batch is scored against every document in one jitted pass — term
matching is a vector-wide equality reduction, streamed chunk-by-chunk like the
brute-force vector scan.

    terms   [C, U]  int32 unique hashed term ids per doc, 0-padded (PAD)
    tf      [C, U]  int32 occurrence count of each term
    length  [C]     int32 true total token count (BM25 length norm)
    valid   [C]     bool

The count representation makes scoring exact for any document length as
long as the doc has ≤ U distinct terms (U = 256): a 10k-token article
stores all its term frequencies, where the round-1 token-stream layout
head-truncated at 256 tokens and double-punished long docs (full-length
norm, zero tf past the cut).  Docs with > U distinct terms keep the U
highest-tf terms; the drop is logged and df bookkeeping uses exactly
the kept set, so idf can never drift under add/remove churn.

Scoring is standard BM25 (k1=1.2, b=0.75) with idf from live document
frequencies tracked host-side.  The hash only folds the vocabulary
(collisions merge rare terms, the standard hashed-vocabulary trade).

Queries go through the full simple_query_string parser (query.py):
flat queries (words, +/- operators, adjacency phrases) are enforced
on-device via presence masks; structured ones (parens, prefix ``*``,
fuzziness ``~N``, phrase slop) score their positive terms on-device and
verify the boolean AST host-side over the overfetched top candidates.
Prefix/fuzzy leaves expand against the host-side term vocabulary
(most-frequent-first, capped).
"""

from __future__ import annotations

import logging
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.persistio import atomic_savez_compressed

from ..core.topk import INF, SENTINEL
from . import query as query_mod
from . import tokenizer

log = logging.getLogger("vst.bm25")

K1 = 1.2
B = 0.75
PAD = 0


def _edit_distance_le(a: str, b: str, n: int) -> bool:
    """Levenshtein(a, b) <= n, banded DP with early exit."""
    if a == b:
        return True
    la, lb = len(a), len(b)
    if abs(la - lb) > n:
        return False
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        lo = max(1, i - n)
        hi = min(lb, i + n)
        if lo > 1:
            cur[lo - 1] = n + 1
        for j in range(lo, hi + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        if hi < lb:
            cur[hi + 1 :] = [n + 1] * (lb - hi)
        if min(cur[lo - 1 : hi + 1]) > n:
            return False
        prev = cur
    return prev[lb] <= n

MAX_DOC_TERMS = 256  # U: distinct terms kept per document
MAX_QUERY_TERMS = 16  # T: scored query terms (first T unique)
# TR/TN: required / forbidden term slots per query.  The parser falls
# back to the host-AST path when a flat query would overflow these, so
# the [:MAX_OP_TERMS] packing below never truncates real operator ids.
MAX_OP_TERMS = query_mod.MAX_OP_TERMS

# phrase queries fetch extra candidates to survive the host-side
# positional filter
PHRASE_OVERFETCH = 4


def _score_topk_impl(
    terms: jnp.ndarray,  # [C, U] int32 unique term ids
    tf: jnp.ndarray,  # [C, U] int32 counts
    length: jnp.ndarray,  # [C] int32
    valid: jnp.ndarray,  # [C] bool
    q_terms: jnp.ndarray,  # [Q, T] int32, PAD-padded
    q_idf: jnp.ndarray,  # [Q, T] f32 (0 for PAD)
    q_req: jnp.ndarray,  # [Q, TR] int32 required ids (PAD = unused)
    q_neg: jnp.ndarray,  # [Q, TN] int32 forbidden ids (PAD = unused)
    avg_len: jnp.ndarray,  # [] f32
    k: int,
    chunk: int = 1 << 13,
    use_ops: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """BM25 top-k: returns (score[Q,k] descending, ids[Q,k]).

    Unjitted core — BM25Index wraps it in jit below; the sharded twin
    (text/sharded_bm25.py) calls it per shard inside shard_map."""
    C, U = terms.shape
    Q, T = q_terms.shape
    n_chunks = -(-C // chunk)
    pad = n_chunks * chunk - C
    if pad:
        terms = jnp.pad(terms, ((0, pad), (0, 0)), constant_values=PAD)
        tf = jnp.pad(tf, ((0, pad), (0, 0)))
        length = jnp.pad(length, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    term_c = terms.reshape(n_chunks, chunk, U)
    tf_c = tf.reshape(n_chunks, chunk, U)
    len_c = length.reshape(n_chunks, chunk)
    val_c = valid.reshape(n_chunks, chunk)

    init = (
        jnp.full((Q, k), -INF),
        jnp.full((Q, k), SENTINEL, dtype=jnp.int32),
    )

    def body(carry, inp):
        best_s, best_i = carry
        toks, tfs, lens, vals, cidx = inp
        # tfq[q, c, t] = stored count of query term t in doc c
        eq = toks[None, :, :, None] == q_terms[:, None, None, :]  # [Q,c,U,T]
        tfq = jnp.sum(
            eq * tfs[None, :, :, None].astype(jnp.float32), axis=2
        )  # [Q, c, T]
        norm = 1.0 - B + B * (lens.astype(jnp.float32) / avg_len)  # [c]
        denom = tfq + (K1 * norm)[None, :, None]
        s = jnp.sum(q_idf[:, None, :] * tfq * (K1 + 1.0) / denom, axis=-1)
        ok = vals[None, :]
        if use_ops:
            # presence masks: required terms must all appear, forbidden none
            req_eq = toks[None, :, :, None] == q_req[:, None, None, :]
            req_present = jnp.any(req_eq, axis=2)  # [Q, c, TR]
            req_ok = jnp.all(
                req_present | (q_req == PAD)[:, None, :], axis=-1
            )
            # PAD guard: padded doc-term slots (0) must not match padded
            # q_neg slots (0) — only real forbidden ids count
            neg_eq = (toks[None, :, :, None] == q_neg[:, None, None, :]) & (
                q_neg != PAD
            )[:, None, None, :]
            neg_hit = jnp.any(jnp.any(neg_eq, axis=2), axis=-1)  # [Q, c]
            ok = ok & req_ok & ~neg_hit
        s = jnp.where(ok, s, -INF)
        cs, ci = jax.lax.top_k(s, min(k, chunk))
        ci = ci + cidx * chunk
        ci = jnp.where(jnp.isinf(cs), SENTINEL, ci)
        ms = jnp.concatenate([best_s, cs], axis=-1)
        mi = jnp.concatenate([best_i, ci], axis=-1)
        ns, pos = jax.lax.top_k(ms, k)
        ni = jnp.take_along_axis(mi, pos, axis=-1)
        return (ns, ni), None

    (best_s, best_i), _ = jax.lax.scan(
        body,
        init,
        (term_c, tf_c, len_c, val_c, jnp.arange(n_chunks, dtype=jnp.int32)),
    )
    return best_s, best_i


_score_topk = jax.jit(
    _score_topk_impl, static_argnames=("k", "chunk", "use_ops")
)


class BM25Index:
    """Slot-addressed text index (the SlotIndex analogue for text).

    Host keeps tokenisation, document frequencies and slot allocation;
    the device keeps term/count arrays and does all scoring.
    """

    QUERY_BUCKETS = (1, 8, 32, 128)

    def __init__(self, initial_capacity: int = 1 << 14) -> None:
        cap = max(initial_capacity, 1024)
        self._terms = np.zeros((cap, MAX_DOC_TERMS), dtype=np.int32)
        self._tf = np.zeros((cap, MAX_DOC_TERMS), dtype=np.int32)
        self._length = np.zeros((cap,), dtype=np.int32)
        self._valid = np.zeros((cap,), dtype=bool)
        self._frontier = 0
        self._size = 0
        self._df: Counter = Counter()  # term id → doc frequency (kept terms)
        self._vocab: dict[str, int] = {}  # term string → id (for prefix/fuzzy)
        # expansion side-indexes: fuzzy scans only the ±dist length
        # buckets; prefix bisects a lazily re-sorted word list — both
        # bound per-leaf host work far below O(vocabulary)
        self._vocab_by_len: dict[int, list[tuple[str, int]]] = {}
        self._vocab_sorted: list[tuple[str, int]] = []
        self._vocab_dirty = False
        self._total_len = 0
        # full token sequences (host only) for phrase verification
        self._seqs: list[np.ndarray | None] = []
        # device arrays are the scoring source of truth; host mutations
        # accumulate in `_dirty_slots` and flush as one row scatter per
        # query (not a full re-upload — documents are long-lived)
        self._dirty_slots: set[int] = set()
        self._dev = None  # (terms, tf, length, valid) device arrays
        self._dev_rows = 0  # device array row count (grows with frontier)

    # -- mutation ---------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = self._terms.shape[0]
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        self._terms = np.pad(self._terms, ((0, new_cap - cap), (0, 0)))
        self._tf = np.pad(self._tf, ((0, new_cap - cap), (0, 0)))
        self._length = np.pad(self._length, (0, new_cap - cap))
        self._valid = np.pad(self._valid, (0, new_cap - cap))

    def add(self, text: str) -> int:
        """Insert a document, returns its slot."""
        words = tokenizer.tokenize(text)
        ids = [tokenizer.term_id(w) for w in words]
        for w, t in zip(words, ids):
            if w not in self._vocab:
                self._vocab[w] = t
                self._vocab_by_len.setdefault(len(w), []).append((w, t))
                self._vocab_dirty = True
        counts = Counter(ids)
        if len(counts) > MAX_DOC_TERMS:
            kept_pairs = counts.most_common(MAX_DOC_TERMS)
            log.warning(
                "document exceeds %d distinct terms (%d); dropping %d rare terms",
                MAX_DOC_TERMS,
                len(counts),
                len(counts) - MAX_DOC_TERMS,
            )
        else:
            kept_pairs = list(counts.items())
        slot = self._frontier
        self._grow(slot + 1)
        u = len(kept_pairs)
        self._terms[slot, :u] = [t for t, _ in kept_pairs]
        self._terms[slot, u:] = PAD
        self._tf[slot, :u] = [c for _, c in kept_pairs]
        self._tf[slot, u:] = 0
        self._length[slot] = len(ids)
        self._valid[slot] = True
        self._frontier += 1
        self._size += 1
        # df over exactly the stored term set — remove() subtracts the
        # same set, so idf cannot drift under churn
        self._df.update(t for t, _ in kept_pairs)
        self._total_len += len(ids)
        while len(self._seqs) <= slot:
            self._seqs.append(None)
        self._seqs[slot] = np.asarray(ids, dtype=np.int32)
        self._dirty_slots.add(slot)
        return slot

    def remove(self, slot: int) -> None:
        if not (0 <= slot < self._frontier) or not self._valid[slot]:
            return
        stored = self._terms[slot]
        self._df.subtract(int(t) for t in stored if t != PAD)
        self._total_len -= int(self._length[slot])
        self._valid[slot] = False
        self._size -= 1
        self._seqs[slot] = None
        self._dirty_slots.add(slot)

    def count(self) -> int:
        return self._size

    # -- persistence -------------------------------------------------------

    FORMAT_VERSION = 1

    def save(self, path: str) -> None:
        """Snapshot the host source-of-truth to one ``.npz``.

        Same posture as core/persist.py: the reference has no text-index
        persistence (indexes rebuild from source, opensearch.rs:99-105);
        this closes that gap.  Device arrays are derived state and are
        not saved — the first query after load re-uploads."""
        f = self._frontier
        seqs = [
            self._seqs[s] if s < len(self._seqs) and self._seqs[s] is not None
            else np.empty((0,), dtype=np.int32)
            for s in range(f)
        ]
        off = np.zeros((f + 1,), dtype=np.int64)
        if f:
            off[1:] = np.cumsum([len(s) for s in seqs])
        words = sorted(self._vocab)
        atomic_savez_compressed(
            path,
            version=np.int64(self.FORMAT_VERSION),
            terms=self._terms[:f],
            tf=self._tf[:f],
            length=self._length[:f],
            valid=self._valid[:f],
            seq_data=(
                np.concatenate(seqs) if f else np.empty((0,), dtype=np.int32)
            ),
            seq_off=off,
            vocab_words=np.asarray(words, dtype=np.str_),
            vocab_ids=np.asarray(
                [self._vocab[w] for w in words], dtype=np.int64
            ),
        )

    @classmethod
    def load(cls, path: str, **kwargs) -> "BM25Index":
        """Restore a snapshot; df / avg-length bookkeeping is rebuilt
        from the stored rows (they are its exact definition — add()
        updates df over the kept term set only)."""
        z = np.load(path)
        if int(z["version"]) != cls.FORMAT_VERSION:
            raise ValueError(f"unsupported snapshot version {z['version']}")
        f = int(z["terms"].shape[0])
        idx = cls(initial_capacity=max(f, 1), **kwargs)
        idx._grow(f)
        idx._terms[:f] = z["terms"]
        idx._tf[:f] = z["tf"]
        idx._length[:f] = z["length"]
        idx._valid[:f] = z["valid"]
        idx._frontier = f
        idx._size = int(idx._valid[:f].sum())
        off = z["seq_off"]
        data = z["seq_data"]
        idx._seqs = [
            np.asarray(data[off[s] : off[s + 1]], dtype=np.int32)
            if idx._valid[s]
            else None
            for s in range(f)
        ]
        # rows store unique terms, so the flattened live rows count doc
        # frequency directly
        live = idx._terms[:f][idx._valid[:f]].ravel()
        live = live[live != PAD]
        uniq, cnt = np.unique(live, return_counts=True)
        idx._df.update(dict(zip(uniq.tolist(), cnt.tolist())))
        idx._total_len = int(idx._length[:f][idx._valid[:f]].sum())
        for w, t in zip(z["vocab_words"], z["vocab_ids"]):
            w, t = str(w), int(t)
            idx._vocab[w] = t
            idx._vocab_by_len.setdefault(len(w), []).append((w, t))
        idx._vocab_dirty = True
        return idx

    # -- query ------------------------------------------------------------

    def _device_arrays(self):
        # pad device rows to a power-of-two bucket so growth (full upload)
        # is a doubling event, not a per-add one; padded rows score as
        # invalid (host _valid is False beyond the frontier)
        rows = 1 << max(self._frontier, 1024).bit_length()
        rows = min(rows, self._terms.shape[0])
        if self._dev is None or self._dev_rows != rows:
            # (re)size: full upload — happens on first query after growth,
            # amortised by the doubling host capacity
            self._dev = (
                jnp.asarray(self._terms[:rows]),
                jnp.asarray(self._tf[:rows]),
                jnp.asarray(self._length[:rows]),
                jnp.asarray(self._valid[:rows]),
            )
            self._dev_rows = rows
            self._dirty_slots.clear()
        elif self._dirty_slots:
            # incremental: scatter only the mutated rows
            slots = np.fromiter(self._dirty_slots, dtype=np.int32)
            slots = slots[slots < rows]
            terms, tf, length, valid = self._dev
            idx = jnp.asarray(slots)
            self._dev = (
                terms.at[idx].set(jnp.asarray(self._terms[slots])),
                tf.at[idx].set(jnp.asarray(self._tf[slots])),
                length.at[idx].set(jnp.asarray(self._length[slots])),
                valid.at[idx].set(jnp.asarray(self._valid[slots])),
            )
            self._dirty_slots.clear()
        return self._dev

    def _score(self, arrays, q_terms, q_idf, q_req, q_neg, avg, k, use_ops):
        """Device scoring seam — the sharded twin overrides this with a
        shard_map'd call (text/sharded_bm25.py)."""
        return _score_topk(
            *arrays, q_terms, q_idf, q_req, q_neg, avg, k, use_ops=use_ops
        )

    def _idf(self, term: int) -> float:
        n, df = max(self._size, 1), self._df.get(term, 0)
        return float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))

    # -- vocabulary expansion (query.Expander seam) -------------------------

    def expand_prefix(self, prefix: str, limit: int) -> list[int]:
        """Live term ids whose stored string starts with `prefix`,
        most-frequent first (simple_query_string `word*`).  Bisects a
        lazily re-sorted vocab list: O(log V + matches) per leaf."""
        if not prefix:
            return []
        import bisect

        if self._vocab_dirty:
            self._vocab_sorted = sorted(self._vocab.items())
            self._vocab_dirty = False
        lo = bisect.bisect_left(self._vocab_sorted, (prefix,))
        hi = bisect.bisect_left(self._vocab_sorted, (prefix[:-1] + chr(ord(prefix[-1]) + 1),))
        hits = [
            (self._df.get(t, 0), t)
            for w, t in self._vocab_sorted[lo:hi]
            if self._df.get(t, 0) > 0
        ]
        hits.sort(key=lambda x: -x[0])
        return [t for _, t in hits[:limit]]

    def expand_fuzzy(self, word: str, dist: int, limit: int) -> list[int]:
        """Live term ids within edit distance `dist` of `word`
        (simple_query_string `word~N`).  Scans only the length buckets
        within ±dist of len(word) — never the whole vocabulary."""
        if not word:
            return []
        hits = []
        for length in range(max(1, len(word) - dist), len(word) + dist + 1):
            for w, t in self._vocab_by_len.get(length, ()):
                if self._df.get(t, 0) <= 0:
                    continue
                if _edit_distance_le(word, w, dist):
                    hits.append((self._df.get(t, 0), t))
        hits.sort(key=lambda x: -x[0])
        return [t for _, t in hits[:limit]]

    def search(self, texts: list[str], k: int) -> list[list[tuple[int, float]]]:
        """Batch of query strings → per query [(slot, score) descending].

        Supports the simple_query_string operator subset (query.py):
        +required, -forbidden, "phrases" (positional, host-verified)."""
        if self._size == 0:
            return [[] for _ in texts]
        parsed = [query_mod.parse(t, expander=self) for t in texts]
        use_ops = any(
            p.required or p.forbidden or p.phrases or p.neg_phrases
            for p in parsed
        )
        # structured (AST) queries and phrases are verified host-side over
        # an overfetched candidate set
        any_host = any(
            p.phrases or p.neg_phrases or p.ast is not None for p in parsed
        )

        Q = len(texts)
        b = next((x for x in self.QUERY_BUCKETS if Q <= x), Q)
        # T buckets like Q buckets: long bag-of-words queries score ALL
        # their terms (OpenSearch does), not a silent head-16 truncation;
        # each bucket is its own compiled variant.  Past the largest
        # bucket, keep the highest-idf terms — rare terms carry BM25.
        t_max = max((len(p.terms) for p in parsed), default=0)
        T = next(
            (t for t in (MAX_QUERY_TERMS, 32, 64) if t_max <= t),
            64,
        )
        if t_max > 64:
            log.warning(
                "query with %d unique terms; scoring the 64 highest-idf",
                t_max,
            )
        q_terms = np.zeros((b, T), dtype=np.int32)
        q_idf = np.zeros((b, T), dtype=np.float32)
        q_req = np.zeros((b, MAX_OP_TERMS), dtype=np.int32)
        q_neg = np.zeros((b, MAX_OP_TERMS), dtype=np.int32)
        for j, p in enumerate(parsed):
            uniq = p.terms
            if len(uniq) > T:
                uniq = sorted(uniq, key=self._idf, reverse=True)[:T]
            q_terms[j, : len(uniq)] = uniq
            q_idf[j, : len(uniq)] = [self._idf(t) for t in uniq]
            req = p.required[:MAX_OP_TERMS]
            q_req[j, : len(req)] = req
            neg = p.forbidden[:MAX_OP_TERMS]
            q_neg[j, : len(neg)] = neg

        k_fetch = min(PHRASE_OVERFETCH * k, self._frontier) if any_host else k
        k_fetch = max(k_fetch, k)
        arrays = self._device_arrays()
        avg = np.float32(max(self._total_len / max(self._size, 1), 1.0))
        scores, ids = self._score(
            arrays,
            jnp.asarray(q_terms),
            jnp.asarray(q_idf),
            jnp.asarray(q_req),
            jnp.asarray(q_neg),
            jnp.float32(avg),
            k_fetch,
            use_ops,
        )
        scores, ids = jax.device_get((scores, ids))
        out = []
        for j in range(Q):
            p = parsed[j]
            # a pure-operator query ("-word") scores 0 on every surviving
            # doc; accept zero scores in that case, otherwise require > 0
            min_ok = -0.5 if (not p.terms and p.has_operators) else 0.0
            hits = []
            for s, sc in zip(ids[j], scores[j]):
                if s == 2**31 - 1 or not np.isfinite(sc) or sc <= min_ok:
                    continue
                slot = int(s)
                if p.phrases or p.neg_phrases:
                    seq = self._seqs[slot] if slot < len(self._seqs) else None
                    if seq is None:
                        continue
                    if any(not query_mod.phrase_in(seq, ph) for ph in p.phrases):
                        continue
                    if any(query_mod.phrase_in(seq, ph) for ph in p.neg_phrases):
                        continue
                if p.ast is not None:
                    seq = self._seqs[slot] if slot < len(self._seqs) else None
                    row = self._terms[slot]
                    term_set = set(int(t) for t in row[row != PAD])
                    if not query_mod.matches(p.ast, term_set, seq):
                        continue
                hits.append((slot, float(sc)))
                if len(hits) == k:
                    break
            out.append(hits)
        return out
