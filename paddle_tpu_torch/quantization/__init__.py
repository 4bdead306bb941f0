"""Weight-only int8 quantization for serving (numpy quantizer, leaf
rewrite of the params tree)."""
from .int8 import quantize_weight, quantize_weight_stacked
from .serving import HEAD_LEAF, QUANT_LEAVES, quantize_serving_params

__all__ = ["quantize_weight", "quantize_weight_stacked", "QUANT_LEAVES",
           "HEAD_LEAF", "quantize_serving_params"]
