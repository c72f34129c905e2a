"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity; at the card's full 700 W power limit). The
benchmark's own table: ``repro_torch.analysis.roofline.HW`` is the
program's planner input and may move with it."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
             "float32": 67e12, "float8": 1979e12, "int8": 1979e12}


def least_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    at the precision's peak and the bytes at the memory's rate."""
    return max(flops / OPS_PER_S[precision], nbytes / HBM_BYTES_PER_S)


def dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[name]
