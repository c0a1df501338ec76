"""SGLANG-LSM core: prefix-preserving LSM storage engine for KV cache
(paper §3), plus the baseline backends it is evaluated against."""

from .backend import StorageBackend, merge_stats
from .baselines import FilePerObjectStore, MemoryOnlyStore
from .codec import CODEC_INT8, CODEC_RAW, BatchCodec
from .controller import AdaptiveController
from .costmodel import TreeShape, cost_terms, optimize, weighted_cost
from .keycodec import block_key, decode_tokens, encode_tokens
from .lsm import LSMTree
from .sharded_store import ShardedKVBlockStore, shard_of
from .store import KVBlockStore, StoreStats

__all__ = [
    "StorageBackend",
    "merge_stats",
    "StoreStats",
    "KVBlockStore",
    "ShardedKVBlockStore",
    "shard_of",
    "FilePerObjectStore",
    "MemoryOnlyStore",
    "LSMTree",
    "AdaptiveController",
    "BatchCodec",
    "CODEC_INT8",
    "CODEC_RAW",
    "TreeShape",
    "cost_terms",
    "weighted_cost",
    "optimize",
    "encode_tokens",
    "decode_tokens",
    "block_key",
]
