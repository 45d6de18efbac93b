from .api import (cache_specs, init_cache, init_params, make_decode_fn,
                  make_prefill_fn)
from .transformer import forward, padded_vocab

__all__ = ["cache_specs", "init_cache", "init_params", "make_decode_fn",
           "make_prefill_fn", "forward", "padded_vocab"]
