"""Per-image table lookup, kernel K15 (counterpart of the JAX package's
ops/lookup.py).

    out[b, n] = table[b, idx[b, n]]

K15 ``table_lookup`` (csrc/lookup.cu) replaces
``ops/lookup.py::_lookup_kernel``, which gathered through a one-hot matmul
because the TPU's dynamic gather is slow; here each thread reads and
writes four pixels at a time (16 bytes) and reads the table through the
L1, so a table of any size S >= 1 works. The graph stage uses it to
broadcast region ids to pixels. The wrapper launches K15 for CUDA tensors
and runs ``table_lookup_plain`` for CPU tensors. ``idx`` must lie in
[0, S). ``table_lookup_int``, the reference's exact form for tables of
values past bf16's integers, is the same call.
"""

from __future__ import annotations

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels


def table_lookup_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of K15 (same contract as table_lookup)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return table[rows, idx.long()].to(torch.int32)


def table_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 indices in [0, S) + (B, S) int32 table -> (B, N) int32."""
    _kernels.check(idx.dim() == 2 and table.dim() == 2 and idx.shape[0] == table.shape[0],
                   "idx must be (B, N) and table (B, S)")
    _kernels.check(idx.dtype == torch.int32 and table.dtype == torch.int32,
                   "idx and table must be int32")
    if _kernels.use_plain(idx, table):
        return table_lookup_plain(idx, table)
    b, n = idx.shape
    s = table.shape[1]
    _kernels.check(s >= 1, f"the table must have at least one entry, got {s}")
    idx, table = idx.contiguous(), table.contiguous()
    _kernels.check(idx.data_ptr() % 16 == 0, "idx must start on a 16-byte boundary")
    out = torch.empty_like(idx)
    _kernels.launch("gcis_table_lookup", idx.data_ptr(), table.data_ptr(), out.data_ptr(),
                    b, n, s)
    table_lookup.launches += 1
    return out


table_lookup.launches = 0


def table_lookup_int(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The reference's exact lookup for int32 tables of pixel-index-scale
    values (it splits them into bf16-exact digits for its one-hot matmul
    kernel): K15 reads int32 tables exactly, so this is ``table_lookup``."""
    return table_lookup(idx, table)
