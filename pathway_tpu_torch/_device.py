"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to CUDA. The
CPU runs only when the caller asks for it (the CPU tests do): a missing
card is an error, never a silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device, after checking it can be used.

    For a CUDA device this also sets the numerics the port is held to:
    float32 matrix products in full float32 (no TF32, for cuBLAS and
    cuDNN alike) and bf16 products without reduced-precision reductions,
    so the KNN scores and the encoder's f32 path match the JAX package's
    float32 arithmetic. A CUDA device comes back with its index ("cuda"
    -> "cuda:<current>"), so it compares equal to the device of the
    tensors made on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pathway_tpu_torch runs on an "
                "NVIDIA GPU by default; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
