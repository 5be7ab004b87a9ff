"""Text index type: tokenizer + device-scored BM25 (SURVEY §7.6)."""

from .bm25 import BM25Index  # noqa: F401
from .sharded_bm25 import ShardedBM25Index  # noqa: F401
from .tokenizer import term_ids, tokenize  # noqa: F401
