from mmlspark_tpu_torch.quant.gate import accuracy_gate
from mmlspark_tpu_torch.quant.quantize import (INT8_MAX, dequantize_array,
                                               dequantize_bundle,
                                               quantization_mode,
                                               quantize_array_int8,
                                               quantize_bundle, quantize_kv)

__all__ = ["INT8_MAX", "accuracy_gate", "dequantize_array", "dequantize_bundle",
           "quantization_mode", "quantize_array_int8", "quantize_bundle",
           "quantize_kv"]
