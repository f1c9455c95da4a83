"""Carry bank state across from the JAX reference: numpy arrays in (as
``np.asarray`` gives them from the reference's LevelFeatures and weight
builders), the port's tensors out.  Lets a test feed both packages the
identical bank."""

from __future__ import annotations

import numpy as np
import torch

from .ops.match import BankWeights, LevelFeatures, MatmulWeight


def level_features_from_numpy(offsets, oris, live, count, size,
                              device="cpu") -> LevelFeatures:
    """The reference's LevelFeatures fields -> the port's LevelFeatures."""
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)
    return LevelFeatures(
        offsets=t(offsets, torch.int32), oris=t(oris, torch.int32),
        live=t(live, torch.bool), count=t(count, torch.int32),
        size=t(size, torch.int32),
    )


def bank_from_numpy(W_gemm, W_cell, W_fine, W_group=None, group_counts=None,
                    device="cpu") -> BankWeights:
    """The reference's built weights — W_gemm (K, N), W_cell (N, bins),
    W_fine (N, fine bins), W_group (Ng, bins), group_counts (Ng, group) —
    -> the port's BankWeights (zero-padded int8 GEMM operands)."""
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)
    return BankWeights(
        W_gemm=MatmulWeight.from_kn(t(W_gemm, torch.int8)),
        W_cell=MatmulWeight.from_nk(t(W_cell, torch.int8)),
        W_fine=MatmulWeight.from_nk(t(W_fine, torch.int8)),
        W_group=None if W_group is None
        else MatmulWeight.from_nk(t(W_group, torch.int8)),
        group_counts=None if group_counts is None
        else t(group_counts, torch.int32),
    )
