"""AdamW (f32 or int8 moments) and int8 gradient compression.
Counterpart of ``repro.optim``."""
from .adamw import (adamw_init, adamw_update, clip_by_global_norm,  # noqa
                    sum_squares)
from .compress import (dequant_int8, int8_allreduce_grads,  # noqa
                       quant_int8)
