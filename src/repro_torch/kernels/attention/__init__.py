from .decode import (decode_attention_cuda,  # noqa: F401
                     decode_attention_int8_cuda, decode_attention_plain)
from .prefill import (prefill_attention_cuda,  # noqa: F401
                      prefill_attention_int8_cuda, prefill_attention_plain)
from .flash import flash_attention_cuda, flash_attention_plain  # noqa: F401
from .backward import (flash_attention_bwd_cuda,  # noqa: F401
                       flash_attention_bwd_plain)
