"""Quantization for the port: the (I,F) fixed-point quantizers and bit
schedules (``quant.fixed_point``) and the int8 kernel datapath's
quantizers (``quant.int8``)."""
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

__all__ = ["BitSchedule", "INT8_BITS", "Int8Spec", "QFormat", "absmax_scale",
           "dequantize_int8", "fxp_max", "fxp_resolution", "int8_spec",
           "make_bit_schedule", "maybe_quantize", "paper_schedule",
           "quantize", "quantize_int8", "quantize_int8_absmax",
           "quantize_int8_auto", "quantize_int8_fxp", "quantize_ste",
           "quantize_stochastic", "schedule_from_formats",
           "stochastic_round_batched", "transport_bits"]
