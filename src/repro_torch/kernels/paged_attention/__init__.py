from .ops import (decode_attention_kernel, paged_decode,
                  paged_decode_attention, paged_decode_chunk)
from .ref import decode_ring_ref, paged_decode_chunk_ref, paged_decode_ref

__all__ = ["decode_attention_kernel", "decode_ring_ref", "paged_decode",
           "paged_decode_attention", "paged_decode_chunk",
           "paged_decode_chunk_ref", "paged_decode_ref"]
