"""Segment sums whose result does not depend on the order the card adds in.

``index_add`` on CUDA adds with atomics, in whatever order the blocks reach
a row, so a float sum differs in its last bits from run to run. The local
BA's accept test (``err_new < err``) and the culling gates downstream turn
such bits into different maps. ``segment_sum`` makes the same sum with
PyTorch's deterministic algorithm (the indices are sorted and each row is
accumulated in order), and ``index_add`` adds onto a given base the same
way; both leave the process-wide switch as they found it.
"""

from __future__ import annotations

import torch


def index_add(base: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``base.index_add(0, idx, vals)`` as a new tensor, each row's
    additions made in the same order on every run."""
    out = base.clone()
    was_on = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return out.index_add_(0, idx, vals)
    finally:
        torch.use_deterministic_algorithms(was_on, warn_only=warn_only)


def segment_sum(idx: torch.Tensor, vals: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(n_rows, ...) sums of ``vals`` (E, ...) over the rows ``idx`` (E,)
    int64 names, the same on every run."""
    return index_add(torch.zeros((n_rows,) + tuple(vals.shape[1:]),
                                 dtype=vals.dtype, device=vals.device),
                     idx, vals)
