"""The detection net's loss suite (port of box2mask_tpu/nn/losses.py:18-162).

Masked L1 offset / bounds losses over foreground oversegments, optional
axis-aligned IoU loss, BCE bb-score loss against detached per-vote IoU
targets (delayed start epoch through `bb_score_weight`), L1 center-score
loss against the detached offset loss, cross-entropy semantic losses with
-100 ignore labels, and the logging signals (pearson correlations,
accuracy, mIoU), over the padded batch with padding rows masked exactly.
`jax.lax.stop_gradient` is `.detach()`.
"""

from __future__ import annotations

import torch


def masked_mean(x, mask):
    m = mask.float()
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def pearson(x, y, mask):
    """Pearson correlation over masked entries (logging only)."""
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    mx, my = (x * m).sum() / n, (y * m).sum() / n
    dx, dy = (x - mx) * m, (y - my) * m
    cov = (dx * dy).sum()
    sx = torch.sqrt((dx * dx).sum())
    sy = torch.sqrt((dy * dy).sum())
    return cov / torch.clamp(sx * sy, min=1e-8)


def aabb_iou(bbs_a, bbs_b, eps=1e-6):
    """Pairwise-aligned IoU of (N, 6) [min, max] boxes."""
    imin = torch.maximum(bbs_a[:, :3], bbs_b[:, :3])
    imax = torch.minimum(bbs_a[:, 3:], bbs_b[:, 3:])
    inter = torch.prod(torch.clamp(imax - imin, min=0.0), dim=1)
    va = torch.prod(bbs_a[:, 3:] - bbs_a[:, :3], dim=1)
    vb = torch.prod(bbs_b[:, 3:] - bbs_b[:, :3], dim=1)
    return inter / (va + vb - inter + eps)


def to_min_max(centers, bounds):
    return torch.cat([centers - bounds, centers + bounds], dim=1)


def softmax_xent(logits, labels, valid):
    """CE with ignore labels (labels < 0 masked)."""
    mask = (labels >= 0) & valid
    safe = torch.clamp(labels, 0, logits.shape[-1] - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    return masked_mean(nll, mask), mask


def sem_miou(pred_idx, gt_idx, valid, num_classes):
    """Mean IoU over classes present in gt or pred."""
    v = valid & (gt_idx >= 0)
    ious, present = [], []
    for c in range(num_classes):
        p = (pred_idx == c) & v
        g = (gt_idx == c) & v
        inter = (p & g).sum()
        union = (p | g).sum()
        ious.append(inter / (union + 1e-6))
        present.append(union > 0)
    ious = torch.stack(ious)
    present = torch.stack(present).float()
    return (ious * present).sum() / torch.clamp(present.sum(), min=1.0)


def compute_losses(cfg, pred, batch, bb_score_weight, center_score_weight):
    """Weighted loss dict; `optimization_loss` is the one to minimize."""
    heads = cfg.network_heads
    losses = {}
    opt_loss = 0.0

    seg_valid = batch['seg_valid'].bool()
    fg = batch['fg_instances'].bool() & seg_valid
    if not cfg.loss_on_fg_instances and not cfg.bb_supervision:
        fg = seg_valid

    loc = batch['input_location']
    gt_off = batch['gt_bb_offsets']
    gt_bnd = batch['gt_bb_bounds']

    offset_l1 = None
    if cfg.mlp_offsets in heads:
        offset_l1 = (pred[cfg.mlp_offsets] - gt_off).abs().sum(1)
        offset_loss = masked_mean(offset_l1, fg)
        opt_loss = opt_loss + cfg.loss_weight_bb_offsets * offset_loss
        losses['offset_loss'] = offset_loss

    if cfg.mlp_bounds in heads:
        bounds_l1 = (pred[cfg.mlp_bounds] - gt_bnd).abs().sum(1)
        bounds_loss = masked_mean(bounds_l1, fg)
        opt_loss = opt_loss + cfg.loss_weight_bb_bounds * bounds_loss
        losses['bounds_loss'] = bounds_loss

    if cfg.use_bb_iou_loss:
        pb = torch.clamp(pred[cfg.mlp_bounds], min=cfg.min_bb_size)
        pr = to_min_max(pred[cfg.mlp_offsets] + loc, pb)
        gt = to_min_max(gt_off + loc, gt_bnd)
        iou_loss = masked_mean(1.0 - aabb_iou(pr, gt), fg)
        opt_loss = opt_loss + cfg.loss_weight_bb_iou * iou_loss
        losses['iou_loss'] = iou_loss

    if cfg.mlp_bb_scores in heads:
        scores = pred[cfg.mlp_bb_scores][:, 0]
        pb = torch.clamp(pred[cfg.mlp_bounds], min=cfg.min_bb_size)
        pr = to_min_max(pred[cfg.mlp_offsets] + loc, pb)
        gt = to_min_max(gt_off + loc, gt_bnd)
        target = aabb_iou(gt, pr).detach()
        bce = (torch.clamp(scores, min=0) - scores * target
               + torch.log1p(torch.exp(-scores.abs())))
        score_loss = masked_mean(bce, fg)
        opt_loss = opt_loss + bb_score_weight * score_loss
        losses['bb_score_loss'] = score_loss
        losses['bb_target_scores'] = masked_mean(target, fg)
        losses['bb_scores_correlation'] = pearson(target, scores, fg)

    if cfg.mlp_center_scores in heads and offset_l1 is not None:
        scores = pred[cfg.mlp_center_scores][:, 0]
        gt_scores = offset_l1.detach()
        cs_mask = fg if cfg.loss_on_fg_instances else seg_valid
        cs_loss = masked_mean((scores - gt_scores).abs(), cs_mask)
        opt_loss = opt_loss + center_score_weight * cs_loss
        losses['center_score_loss'] = cs_loss
        losses['center_scores_correlation'] = pearson(gt_scores, scores,
                                                      cs_mask)

    if cfg.mlp_semantics in heads:
        logits = pred[cfg.mlp_semantics]
        gt_idx = batch['gt_semantics_idx']     # id->index mapped, -100 ignore
        sem_loss, _ = softmax_xent(logits, gt_idx, seg_valid)
        pred_idx = logits.argmax(1)
        acc = masked_mean((pred_idx == gt_idx).float(), seg_valid)
        opt_loss = opt_loss + cfg.loss_weight_semantics * sem_loss
        losses['semantics_loss'] = sem_loss
        losses['semantics_acc'] = acc
        losses['semantics_mIoU'] = sem_miou(pred_idx, gt_idx, seg_valid,
                                            logits.shape[-1])

    if cfg.mlp_per_vox_semantics in heads:
        logits = pred[cfg.mlp_per_vox_semantics]
        gt_idx = batch['gt_per_vox_semantics_idx']
        vvalid = batch['valid0'].bool()
        pv_loss, _ = softmax_xent(logits, gt_idx, vvalid)
        pred_idx = logits.argmax(1)
        pv_acc = masked_mean((pred_idx == gt_idx).float(), vvalid)
        opt_loss = opt_loss + cfg.loss_weight_per_vox_semantics * pv_loss
        losses['per_vox_semantics_loss'] = pv_loss
        losses['per_vox_semantics_acc'] = pv_acc

    losses['optimization_loss'] = opt_loss
    return losses
