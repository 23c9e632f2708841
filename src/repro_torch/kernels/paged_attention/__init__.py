from .ops import paged_decode_chunk
from .ref import paged_decode_chunk_ref

__all__ = ["paged_decode_chunk", "paged_decode_chunk_ref"]
