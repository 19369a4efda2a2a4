"""The paper's technique in the LM family (port of ``repro.quantized``):
``qkv_cache``, the int8 KV cache decode.  The recsys int8 tables are
``models.recsys.embedding.QuantizedTable``; the quantized index options
are ``knn``'s."""

from repro_torch.quantized.qkv_cache import (
    QuantizedCache,
    cache_memory_bytes,
    decode_step_q8,
    make_quantized_cache,
    quantize_cache,
    quantized_decode_attention,
)

__all__ = [
    "QuantizedCache",
    "cache_memory_bytes",
    "decode_step_q8",
    "make_quantized_cache",
    "quantize_cache",
    "quantized_decode_attention",
]
