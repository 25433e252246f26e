"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions."""

from whisper_aries_tpu_torch.ops.quant import (
    dequantize_int8,
    quant_matmul,
    quantize_int8,
    quantize_model_params,
)

__all__ = [
    "dequantize_int8",
    "quant_matmul",
    "quantize_int8",
    "quantize_model_params",
]
