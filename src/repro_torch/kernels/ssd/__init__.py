from .ops import ssd_chunk_scan
from .ref import ssd_chunked_ref, ssd_sequential

__all__ = ["ssd_chunk_scan", "ssd_chunked_ref", "ssd_sequential"]
