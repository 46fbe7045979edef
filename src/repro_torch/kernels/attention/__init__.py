from .decode import decode_attention_cuda, decode_attention_plain  # noqa: F401
from .prefill import (prefill_attention_cuda,  # noqa: F401
                      prefill_attention_plain)
