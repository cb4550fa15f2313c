"""Float32 product precision for the reference and its control."""

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    """Let float32 matrix products and convolutions on the GPU run on TF32
    (``enabled``) or in full float32 for the span, then restore."""

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    torch.set_float32_matmul_precision("high" if enabled else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])
