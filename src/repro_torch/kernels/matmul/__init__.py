from .matmul import matmul_cuda, matmul_plain  # noqa: F401
