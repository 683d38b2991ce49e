"""Dtype and matmul-precision policy of the port (counterpart of the JAX
package's ops/precision.py).

The JAX package pins f32 dots to Precision.HIGHEST because a TPU's DEFAULT
precision rounds f32 operands to bf16. The same trap on an NVIDIA card is
TF32: float32 convolutions go through cuDNN in TF32 by default, and matmuls
do where ``allow_tf32`` is on. The port turns both off in both modes. In
bf16 mode tensors are stored in bf16 and every kernel accumulates in f32.
"""

from __future__ import annotations

import torch


def set_policy() -> None:
    """Full float32 matmuls and convolutions (no TF32), in both modes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def storage_dtype(name: str) -> torch.dtype:
    """PipelineConfig.dtype ("float32" | "bfloat16") -> torch dtype."""
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unknown dtype {name!r}")
