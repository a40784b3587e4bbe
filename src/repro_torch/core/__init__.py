"""Core of the port: iSAX, the block and flat indexes, the frontier, the
query engine and its public drivers (``repro.core``)."""
from repro_torch.core import engine, frontier, isax
from repro_torch.core.engine import DTW, Cosine, ED, QueryPlan
from repro_torch.core.frontier import Frontier, QuerySetup, SearchStats
from repro_torch.core.index import (BlockIndex, FlatIndex, build, build_flat,
                                    flat_view)
from repro_torch.core.search import SearchResult, search, search_block_major
from repro_torch.core.paris import search_flat, search_paris
from repro_torch.core.ucr import search_scan

__all__ = [
    "engine", "frontier", "isax", "QueryPlan", "ED", "DTW", "Cosine",
    "Frontier", "QuerySetup", "BlockIndex", "FlatIndex",
    "build", "build_flat", "flat_view", "SearchResult", "SearchStats",
    "search", "search_block_major", "search_flat", "search_paris",
    "search_scan",
]
