from .ops import moe_ffn
from .ref import moe_ffn_ref

__all__ = ["moe_ffn", "moe_ffn_ref"]
