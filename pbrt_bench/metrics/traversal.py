"""Which device kernels are the dense traversal kernels B1 and B2 (names as
the CUDA sources define them); shared by the traversal metrics."""


def is_traversal(name: str) -> bool:
    return "traverse_kernel" in name or "traverse_bf16_kernel" in name
