from .matmul import (grouped_matmul_cuda, grouped_matmul_plain,  # noqa: F401
                     matmul_cuda, matmul_plain, quantized_matmul_cuda,
                     quantized_matmul_plain)
