"""chip_smoke.py's numpy references agree with the system at small
size, so a failure on the card points at the device path, not at the
reference."""

import numpy as np

import chip_smoke


def test_bm25_reference_matches_bm25_index():
    from vector_store_tpu.text.bm25 import BM25Index

    docs, queries = chip_smoke.text_corpus(400, 12, seed=3)
    idx = BM25Index()
    for words in docs:
        idx.add(" ".join(words))
    score = chip_smoke.bm25_reference(docs)
    hits = idx.search([" ".join(q) for q in queries], 10)
    for q, got in zip(queries, hits):
        s = score(q)
        want = np.sort(s[s > 0])[::-1][:10]
        assert len(got) == len(want)
        slots = [slot for slot, _ in got]
        np.testing.assert_allclose(s[slots], want, rtol=1e-6)
        np.testing.assert_allclose([sc for _, sc in got], want, rtol=1e-5)


def test_exact_topk_matches_bruteforce():
    import jax.numpy as jnp

    from vector_store_tpu.core import bruteforce
    from vector_store_tpu.core import distance as dist_mod

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 24)).astype(np.float32)
    q = x[:20] + 0.1 * rng.normal(size=(20, 24)).astype(np.float32)
    want = chip_smoke.exact_topk(x, q, 10)
    dist, ids = bruteforce.search(
        dist_mod.preprocess(jnp.asarray(q), "cosine"),
        dist_mod.preprocess(jnp.asarray(x), "cosine"),
        jnp.ones((3000,), bool),
        "cosine",
        10,
        approx=False,
    )
    assert (np.asarray(ids) == want).all()
    ref = chip_smoke.cosine_distance(x, q, want.tolist())
    np.testing.assert_allclose(np.asarray(dist), np.stack(ref), atol=1e-5)
