from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .compress import dequantize_int8, ef_compress, ef_init, quantize_int8
from .schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "warmup_cosine",
           "quantize_int8", "dequantize_int8", "ef_init", "ef_compress"]
