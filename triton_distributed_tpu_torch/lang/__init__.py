"""The int8 codec of the quantized KV cache."""
