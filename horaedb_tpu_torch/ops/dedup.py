"""Run-boundary and last-value dedup masks over sorted rows.

A port of the JAX package's `ops/dedup.py` to torch: input sorted by
(pk..., __seq__); consecutive rows with equal pks form a group, and in
overwrite mode the group's last row (the highest sequence) wins. These are
the plain versions inside kernels D and F (`ops/merge.py`).
"""

from __future__ import annotations

import torch


def run_starts(key_cols: list[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """Row i begins a new primary-key group (row 0 always does)."""
    n = key_cols[0].shape[0]
    diff = torch.arange(n, device=valid.device) == 0
    for col in key_cols:
        prev = torch.cat([col[:1], col[:-1]])
        diff = diff | (col != prev)
    return diff & valid


def last_in_group_mask(starts: torch.Tensor, valid: torch.Tensor, num_valid: int) -> torch.Tensor:
    """Keep the final row of every group among the first `num_valid`."""
    n = starts.shape[0]
    next_is_new = torch.cat([starts[1:], torch.ones(1, dtype=torch.bool, device=starts.device)])
    is_final_valid_row = torch.arange(n, device=starts.device) == (num_valid - 1)
    return valid & (next_is_new | is_final_valid_row)


def dedup_last_value(columns: dict[str, torch.Tensor], key_names: list[str],
                     num_valid: int) -> torch.Tensor:
    """Keep-mask of overwrite-mode dedup over a sorted block whose first
    `num_valid` rows are valid."""
    n = columns[key_names[0]].shape[0]
    valid = torch.arange(n, device=columns[key_names[0]].device) < num_valid
    starts = run_starts([columns[k] for k in key_names], valid)
    return last_in_group_mask(starts, valid, num_valid)
