from .matmul import (matmul_cuda, matmul_plain,  # noqa: F401
                     quantized_matmul_cuda, quantized_matmul_plain)
