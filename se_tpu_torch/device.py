"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``.  A CUDA
request on a machine without a usable card raises: nothing carries on on
the CPU unasked.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the torch device for ``device``, raising when CUDA is asked
    for and absent.

    On a CUDA device this also turns TF32 off for matrix products and for
    cuDNN convolutions (cuDNN's default is TF32): the reference computes
    in full float32, and the port is held to it.  It also keeps cuBLAS's
    bf16 products reducing in f32: cuBLAS may otherwise sum a split-K
    product's partial results in bf16, where the reference's bf16 einsums
    accumulate in f32 and round once.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
