from mmlspark_tpu_torch.quant.quantize import INT8_MAX, quantize_kv
