"""Optimizers of the port: AdamW with dense or packed moments, gradient
compression with error feedback."""
from .adamw import (AdamWConfig, OptState, adamw_update, cosine_lr,
                    global_norm, init_opt_state)
from .compress import (DEFAULT_GRAD_POLICY, GRAD_COMPRESS_MODES,
                       compress_decompress_grads, compress_grads, ef_init,
                       make_pod_compressed_psum)
from .moments import (FP8_MOMENTS, SUB4_V_MOMENTS, WIDE_RANGE_V,
                      MomentPolicy, PackedMoment, decode_moment,
                      encode_moment, logical_bytes_per_param,
                      physical_bytes_per_param)

__all__ = [
    "AdamWConfig", "OptState", "adamw_update", "cosine_lr", "global_norm",
    "init_opt_state",
    "DEFAULT_GRAD_POLICY", "GRAD_COMPRESS_MODES",
    "compress_decompress_grads", "compress_grads", "ef_init",
    "make_pod_compressed_psum",
    "MomentPolicy", "PackedMoment", "FP8_MOMENTS", "SUB4_V_MOMENTS",
    "WIDE_RANGE_V", "encode_moment", "decode_moment",
    "logical_bytes_per_param", "physical_bytes_per_param",
]
