"""Carry state across from the JAX reference: numpy arrays and plain
fields in (as ``np.asarray`` gives them from the reference's objects), the
port's objects out.  Lets a test feed both packages the identical state:
banks (per-template features, padded arrays, GEMM weights), template pose
metadata, mesh triangles, match sets, the pruning plans, ICP results and
local-descriptor poses (which also go back to numpy, for golden files)."""

from __future__ import annotations

import numpy as np
import torch

from .ops.match import (BankWeights, CoarseMatches, FinePlan, LevelFeatures,
                        Matches, MatmulWeight, PrunePlan, PruneResult)
from .utils.device import DEFAULT_DEVICE, resolve_device


def _t(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=resolve_device(device))


def level_features_from_numpy(offsets, oris, live, count, size,
                              device=DEFAULT_DEVICE) -> LevelFeatures:
    """The reference's LevelFeatures fields -> the port's LevelFeatures."""
    return LevelFeatures(
        offsets=_t(offsets, torch.int32, device), oris=_t(oris, torch.int32, device),
        live=_t(live, torch.bool, device), count=_t(count, torch.int32, device),
        size=_t(size, torch.int32, device),
    )


def bank_from_numpy(W_gemm, W_cell, W_fine, W_group=None, group_counts=None,
                    device=DEFAULT_DEVICE) -> BankWeights:
    """The reference's built weights — W_gemm (K, N), W_cell (N, bins),
    W_fine (N, fine bins), W_group (Ng, bins), group_counts (Ng, group) —
    -> the port's BankWeights (zero-padded int8 GEMM operands)."""
    i8 = lambda a: _t(a, torch.int8, device)
    return BankWeights(
        W_gemm=MatmulWeight.from_kn(i8(W_gemm)),
        W_cell=MatmulWeight.from_nk(i8(W_cell)),
        W_fine=MatmulWeight.from_nk(i8(W_fine)),
        W_group=None if W_group is None else MatmulWeight.from_nk(i8(W_group)),
        group_counts=None if group_counts is None
        else _t(group_counts, torch.int32, device),
    )


def detector_params_from_reference(p):
    """A reference DetectorParams (same field names) -> the port's."""
    from .models.templates import DetectorParams, ModalityParams

    return DetectorParams(
        t_pyramid=tuple(int(t) for t in p.t_pyramid),
        use_color_gradient=bool(p.use_color_gradient),
        use_depth_normal=bool(p.use_depth_normal),
        color=ModalityParams(**vars(p.color)), depth=ModalityParams(**vars(p.depth)),
    )


def templates_from_reference(templates) -> list:
    """The reference's TemplateFeatures list (numpy feature rows (y, x,
    ori) per level and modality) -> the port's TemplateFeatures."""
    from .models.templates import TemplateFeatures

    return [
        TemplateFeatures(
            grad=[np.asarray(g, np.int32).copy() for g in t.grad],
            norm=[np.asarray(n, np.int32).copy() for n in t.norm],
            size=[tuple(int(v) for v in s) for s in t.size],
            rect0=tuple(int(v) for v in t.rect0),
        )
        for t in templates
    ]


def detector_from_reference(bank, device=DEFAULT_DEVICE):
    """A reference TemplateBank -> a port Detector holding the same
    templates (its arrays and weights are rebuilt by the port)."""
    from .models.detector import Detector
    from .models.templates import TemplateBank

    params = detector_params_from_reference(bank.params)
    det = Detector(params, f_cap=bank.f_cap, device=device)
    det.attach_bank(TemplateBank(bank.class_id, params,
                                 templates_from_reference(bank.templates),
                                 f_cap=bank.f_cap))
    return det


def metadata_from_reference(meta):
    """A reference TemplateMetadata -> the port's (numpy fields, copied)."""
    from .models.templates import TemplateMetadata

    return TemplateMetadata(R=np.array(meta.R), T=np.array(meta.T), K=np.array(meta.K),
                            D=np.array(meta.D), Ori_dist=np.array(meta.Ori_dist),
                            Rect=np.array(meta.Rect))


def globals_from_reference(g):
    """A reference RendererGlobals -> the port's (same field names)."""
    from .models.templates import RendererGlobals

    return RendererGlobals(**vars(g))


def triangles_from_numpy(tris, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Padded (Tn, 3, 3) triangles (the reference's device mesh) -> f32."""
    return _t(tris, torch.float32, device)


def matches_from_numpy(template_id, x, y, similarity, valid, device=DEFAULT_DEVICE) -> Matches:
    """Matches fields as numpy -> the port's Matches."""
    return Matches(_t(template_id, torch.int32, device), _t(x, torch.int32, device),
                   _t(y, torch.int32, device), _t(similarity, torch.float32, device),
                   _t(valid, torch.bool, device))


def coarse_matches_from_numpy(template_id, cell_y, cell_x, similarity, valid,
                              device=DEFAULT_DEVICE) -> CoarseMatches:
    """CoarseMatches fields as numpy -> the port's CoarseMatches."""
    return CoarseMatches(_t(template_id, torch.int32, device),
                         _t(cell_y, torch.int32, device), _t(cell_x, torch.int32, device),
                         _t(similarity, torch.float32, device), _t(valid, torch.bool, device))


def prune_plan_from_numpy(t_idx, t_keep, p_idx, p_keep, n_survivors, m_survivors,
                          overflow, device=DEFAULT_DEVICE) -> PrunePlan:
    """PrunePlan fields as numpy -> the port's PrunePlan."""
    i32, b = torch.int32, torch.bool
    return PrunePlan(_t(t_idx, i32, device), _t(t_keep, b, device), _t(p_idx, i32, device),
                     _t(p_keep, b, device), _t(n_survivors, i32, device),
                     _t(m_survivors, i32, device), _t(overflow, b, device))


def fine_plan_from_numpy(p_idx, p_keep, m_survivors, overflow,
                         device=DEFAULT_DEVICE) -> FinePlan:
    """FinePlan fields as numpy -> the port's FinePlan."""
    return FinePlan(_t(p_idx, torch.int32, device), _t(p_keep, torch.bool, device),
                    _t(m_survivors, torch.int32, device), _t(overflow, torch.bool, device))


def prune_result_from_numpy(idx, keep, n_survivors, overflow,
                            device=DEFAULT_DEVICE) -> PruneResult:
    """PruneResult fields as numpy -> the port's PruneResult."""
    return PruneResult(_t(idx, torch.int32, device), _t(keep, torch.bool, device),
                       _t(n_survivors, torch.int32, device), _t(overflow, torch.bool, device))


def icp_result_from_numpy(transform, fitness, num_inliers, iterations, converged,
                          device=DEFAULT_DEVICE):
    """ICPResult fields as numpy -> the port's ICPResult."""
    from .ops.icp import ICPResult

    return ICPResult(_t(transform, torch.float32, device), _t(fitness, torch.float32, device),
                     _t(num_inliers, torch.int32, device), _t(iterations, torch.int32, device),
                     _t(converged, torch.bool, device))


def local_descriptor_pose_from_numpy(pose, votes, n_correspondences, valid,
                                     device=DEFAULT_DEVICE):
    """LocalDescriptorPose fields as numpy -> the port's record."""
    from .ops.local_descriptor import LocalDescriptorPose

    return LocalDescriptorPose(_t(pose, torch.float32, device), _t(votes, torch.int32, device),
                               _t(n_correspondences, torch.int32, device),
                               _t(valid, torch.bool, device))


def record_to_numpy(record, prefix: str = "") -> dict[str, np.ndarray]:
    """A record of tensors (Matches, PrunePlan, FinePlan, PruneResult,
    PooledStats, ICPResult, LocalDescriptorPose, ...) -> {prefix + field: numpy array}: the form the golden
    files hold, and the reference's records take through np.asarray."""
    return {prefix + name: a.detach().cpu().numpy()
            for name, a in record._asdict().items()}
