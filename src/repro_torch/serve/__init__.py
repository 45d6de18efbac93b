from .engine import Engine, PromptTooLongError, Request, ServeConfig
from .paged import PagedKVPool
from .quantized import QTensor, qdot, quantize_params

__all__ = ["Engine", "PromptTooLongError", "Request", "ServeConfig",
           "PagedKVPool", "QTensor", "qdot", "quantize_params"]
