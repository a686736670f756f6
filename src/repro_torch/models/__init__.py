"""The generator LM of RAG serving (dense family): configuration, layers,
parameters, KV cache, prefill and decode."""
from .config import ModelConfig
from .model import (decode_fn, forward, init_cache, init_params,
                    prefill_fn)

__all__ = ["ModelConfig", "init_params", "init_cache", "forward",
           "prefill_fn", "decode_fn"]
