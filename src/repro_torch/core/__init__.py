"""Core of the port: iSAX, the block index, the frontier and the engine."""
from repro_torch.core.index import BlockIndex, build
from repro_torch.core.search import SearchResult, search_block_major

__all__ = ["BlockIndex", "SearchResult", "build", "search_block_major"]
