"""int8 quantization for the port's kernel datapath (see ``quant.int8``)."""
from repro_torch.quant.int8 import (
    INT8_BITS,
    Int8Spec,
    absmax_scale,
    dequantize_int8,
    int8_spec,
    quantize_int8,
    quantize_int8_absmax,
    quantize_int8_auto,
    quantize_int8_fxp,
    transport_bits,
)

__all__ = ["INT8_BITS", "Int8Spec", "absmax_scale", "dequantize_int8",
           "int8_spec", "quantize_int8", "quantize_int8_absmax",
           "quantize_int8_auto", "quantize_int8_fxp", "transport_bits"]
