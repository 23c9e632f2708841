from .ops import flash_attention, flash_attention_bhsd
from .ref import flash_attention_bhsd_ref

__all__ = ["flash_attention", "flash_attention_bhsd",
           "flash_attention_bhsd_ref"]
