"""Quantization for the port: the (I,F) fixed-point quantizers and bit
schedules (``quant.fixed_point``), the int8 kernel datapath's quantizers
and tile container (``quant.int8``) and the dW wire codec
(``quant.compression``)."""
from repro_torch.quant.fixed_point import (
    BitSchedule,
    QFormat,
    fxp_max,
    fxp_resolution,
    make_bit_schedule,
    maybe_quantize,
    paper_schedule,
    quantize,
    quantize_ste,
    quantize_stochastic,
    schedule_from_formats,
    stochastic_round_batched,
)
from repro_torch.quant.compression import (
    compress_int8,
    decompress_int8,
    quantized_allreduce_bytes,
)
from repro_torch.quant.int8 import (
    INT8_BITS,
    TILE,
    BlockScaledInt8,
    Int8Spec,
    absmax_scale,
    dequantize_int8,
    fxp_int8_bounds,
    fxp_int8_scale,
    int8_spec,
    quantize_int8,
    quantize_int8_absmax,
    quantize_int8_auto,
    quantize_int8_fxp,
    quantize_int8_tiles,
    transport_bits,
)

__all__ = ["BitSchedule", "BlockScaledInt8", "INT8_BITS", "Int8Spec",
           "QFormat", "TILE", "absmax_scale", "compress_int8",
           "decompress_int8", "dequantize_int8", "fxp_int8_bounds",
           "fxp_int8_scale", "fxp_max", "fxp_resolution", "int8_spec",
           "make_bit_schedule", "maybe_quantize", "paper_schedule",
           "quantize", "quantize_int8", "quantize_int8_absmax",
           "quantize_int8_auto", "quantize_int8_fxp", "quantize_int8_tiles",
           "quantize_ste", "quantize_stochastic",
           "quantized_allreduce_bytes", "schedule_from_formats",
           "stochastic_round_batched", "transport_bits"]
