from .hierarchy import Acquisition, CacheHierarchy, CacheStats
from .radix import TIER_DEVICE, TIER_DISK, TIER_HOST, TIER_NONE, RadixNode, RadixTree

__all__ = [
    "CacheHierarchy",
    "CacheStats",
    "Acquisition",
    "RadixTree",
    "RadixNode",
    "TIER_DEVICE",
    "TIER_HOST",
    "TIER_DISK",
    "TIER_NONE",
]
