from .adamw import (OptState, adamw_init, adamw_update, global_norm,
                    wsd_schedule)
from .grad_compress import compress_decompress, ef_state_init
