"""PAA head (counterpart of ``swindet_tpu/models/dense_heads/paa_head.py``:
``_np_em_single`` :100, ``PAAHead`` :159 with ``loss`` :165 and
``get_bboxes`` :308; reference mmdet/models/dense_heads/paa_head.py:45,
arXiv:2007.08103).

Probabilistic anchor assignment on ATSS's towers and outputs (the
centerness branch predicts the IoU). The max-IoU assigner's positives are
scored by their joint loss (the focal loss summed over the classes plus
the box loss of the decoded box); each gt's ``topk`` lowest-loss
candidates of every level, sorted, are fit by a two-component 1-D Gaussian
mixture, and the low-loss component's candidates up to its likelihood
peak stay positive; the others become background.

The mixture is :func:`gmm_em_1d`: the EM of the JAX package's host fit
``_np_em_single`` (sklearn's GaussianMixture as the reference fits it), in
float64 on the tensors' device, batched over every (image, gt) row, with
no round trip to the host a row. At test time the scores are
sqrt(class score x IoU), and each detection's box is the score-voted
average of the same-class candidates that overlap it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ...core.anchors import anchor_inside_flags
from ...core.bbox.assigners import smallest_k
from ...core.bbox.iou import bbox_overlaps
from ...core.nms import fast_topk, multiclass_nms
from ...registries import HEADS
from .atss_head import ATSSHead

EPS = 1e-12
INF = 1e8


def _weighted_lp(x, mu, var, w):
    """Each component's weighted log-density at x (R, M): (R, M, 2)."""
    return (-0.5 * ((x[..., None] - mu[:, None]) ** 2 / var[:, None]
                    + torch.log(2 * math.pi * var[:, None]))
            + torch.log(w.clamp(min=EPS))[:, None])


def gmm_em_1d(x: torch.Tensor, valid: torch.Tensor, tol: float = 1e-3,
              max_iter: int = 100, reg: float = 1e-6,
              check_every: int = 8):
    """Two-component 1-D EM of each row of x (R, M) over its ``valid``
    entries (R, M), in float64: the JAX package's ``_np_em_single`` on
    every row at once. Means start at the valid entries' min and max,
    variances at 1 and weights at 1/2; an iteration is an e-step (the mean
    log-likelihood ``lb``) and an m-step (``nk`` + 10 eps, the variances
    plus ``reg``, the weights renormalised). A row whose ``lb`` moved by
    less than ``tol`` keeps the parameters of that iteration's m-step and
    no others, as the numpy loop breaks after it; so the loop, which reads
    whether every row is done once every ``check_every`` iterations,
    returns the same result whenever it stops. A final e-step gives each
    entry's component-0 membership (lp0 >= lp1) and its log-likelihood,
    cast to float32. Returns (resp0 (R, M) bool, loglik (R, M) float32,
    the number of host reads)."""
    x = x.double()
    v = valid.bool()
    r_rows = x.shape[0]
    n = v.sum(-1).clamp(min=1).double()
    xv = torch.where(v, x, 0.0)
    mu = torch.stack([torch.where(v, x, INF).amin(-1),
                      torch.where(v, x, -INF).amax(-1)], -1)
    var = torch.ones_like(mu)
    w = torch.full_like(mu, 0.5)
    eps10 = 10 * torch.finfo(torch.float64).eps
    lb_prev = torch.full((r_rows,), -math.inf, dtype=torch.float64,
                         device=x.device)
    done = torch.zeros((r_rows,), dtype=torch.bool, device=x.device)
    reads = 0
    for it in range(max_iter):
        lp = _weighted_lp(x, mu, var, w)
        lpn = torch.logaddexp(lp[..., 0], lp[..., 1])
        r = torch.where(v[..., None], torch.exp(lp - lpn[..., None]), 0.0)
        lb = torch.where(v, lpn, 0.0).sum(-1) / n
        nk = r.sum(1) + eps10
        mu_n = (r * xv[..., None]).sum(1) / nk
        var_n = (r * (xv ** 2)[..., None]).sum(1) / nk - mu_n ** 2 + reg
        w_n = nk / n[:, None]
        w_n = w_n / w_n.sum(-1, keepdim=True)
        frozen = done[:, None]
        mu = torch.where(frozen, mu, mu_n)
        var = torch.where(frozen, var, var_n)
        w = torch.where(frozen, w, w_n)
        done = done | ((lb - lb_prev).abs() < tol)
        lb_prev = lb
        if (it + 1) % check_every == 0:
            reads += 1
            if bool(done.all()):
                break
    lp = _weighted_lp(x, mu, var, w)
    return (lp[..., 0] >= lp[..., 1],
            torch.logaddexp(lp[..., 0], lp[..., 1]).float(), reads)


def paa_candidates(pos_loss: torch.Tensor, pos: torch.Tensor,
                   gt_idx: torch.Tensor, num_gts: int, level_counts,
                   topk: int):
    """Each (image, gt)'s candidates: the ``topk`` lowest joint losses
    among its positives of every level (the lower index first on ties, as
    ``jax.lax.top_k``), then sorted by loss (stably, the invalid slots
    last). pos_loss, pos and gt_idx are (B, N); returns the anchor
    indices, losses and validity, each (B, G, M)."""
    b, n = pos_loss.shape
    gid = torch.arange(num_gts, device=pos_loss.device)
    mine = pos[:, None] & (gt_idx[:, None] == gid[None, :, None])
    masked = torch.where(mine, pos_loss[:, None], INF)         # (B, G, N)
    idx, start = [], 0
    for count in level_counts:
        k = min(topk, count)
        slab = masked[..., start:start + count].reshape(-1, count)
        idx.append(smallest_k(slab, k).reshape(b, num_gts, k) + start)
        start += count
    ci = torch.cat(idx, -1)
    cl = torch.gather(masked, 2, ci)
    cv = cl < INF / 2
    order = torch.sort(torch.where(cv, cl, INF), dim=-1, stable=True).indices
    return (torch.gather(ci, 2, order), torch.gather(cl, 2, order),
            torch.gather(cv, 2, order))


def paa_select(cl: torch.Tensor, cv: torch.Tensor, em=gmm_em_1d):
    """The candidates (..., M), sorted by loss, that stay positive: the
    mixture's component 0 up to its likelihood peak (the reference's
    separation scheme (c)), where a row has at least two candidates and
    component 0 has any. Returns (selected, host reads)."""
    shape = cl.shape
    resp0, loglik, reads = em(torch.where(cv, cl, 0.0).reshape(-1, shape[-1]),
                              cv.reshape(-1, shape[-1]))
    resp0, loglik = resp0.reshape(shape), loglik.reshape(shape)
    fgs = resp0 & cv
    best = torch.where(fgs, loglik, -INF).argmax(-1, keepdim=True)
    fg_rank = torch.cumsum(fgs.int(), -1) - 1
    sel = fgs & (fg_rank <= torch.gather(fg_rank, -1, best))
    sel &= ((cv.sum(-1) >= 2) & fgs.any(-1))[..., None]
    return sel & cv, reads


def paa_keep(ci: torch.Tensor, sel: torch.Tensor, n: int) -> torch.Tensor:
    """The anchors (B, N) that some (gt, candidate slot) selects: an OR
    over the slots (B, ...) pointing at each, as the JAX package's
    ``.at[ci].max``. An invalid slot points at an arbitrary anchor, and
    must not clear another slot's selection of it."""
    b = ci.shape[0]
    return torch.zeros((b, n), dtype=torch.uint8, device=ci.device) \
        .scatter_reduce(1, ci.reshape(b, -1), sel.reshape(b, -1).to(
            torch.uint8), 'amax').bool()


@HEADS.register_module()
class PAAHead(ATSSHead):
    """ATSS's head with the centerness branch read as the predicted IoU
    (mmdet keeps the name ``atss_centerness``), ``topk`` candidates a
    level a gt, and score voting at test time. ``reg_decoded_bbox`` is
    taken and always on: the box loss runs on decoded boxes.
    ``covariance_type`` is taken and unused: a 1-D mixture's 'diag' is its
    only form."""

    def __init__(self, *args, topk: int = 9, score_voting: bool = True,
                 covariance_type: str = 'diag',
                 reg_decoded_bbox: bool = True, **kwargs):
        self.topk = int(topk)
        self.score_voting = score_voting
        super().__init__(*args, **kwargs)

    # --------------------------------------------------------------- loss
    def paa_targets(self, featmap_sizes, cls_flat, box_flat, gt_bboxes,
                    gt_valid, gt_labels, img_shapes, pad_shapes, em=None):
        """Per image the max-IoU assignment (every inside anchor counted,
        PseudoSampler semantics) thinned by PAA: labels (B, N)
        (``num_classes`` the background), label weights (the inside flags),
        positives, the assigned gts' boxes (B, N, 4), the decoded boxes,
        and the EM's host reads. ``em`` replaces the
        positive selection's fit (``paa_select``'s ``em``)."""
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    gt_bboxes.device)
        flat = torch.cat(anchors)
        n, (b, g) = flat.shape[0], gt_bboxes.shape[:2]
        cfg = self.train_cfg
        labels, label_weights, pos, gt_idx = [], [], [], []
        for i in range(b):
            valid = torch.cat(self.prior_generator.valid_flags(
                featmap_sizes, pad_shapes[i]))
            inside = anchor_inside_flags(flat, valid, img_shapes[i],
                                         cfg.get('allowed_border', -1))
            a = self.assigner.assign(flat, gt_bboxes[i].float(), gt_valid[i],
                                     gt_labels[i], bbox_valid=inside)
            p = a.gt_inds > 0
            pos.append(p)
            gt_idx.append((a.gt_inds.long() - 1).clamp(min=0))
            labels.append(torch.where(p, a.labels.long().clamp(min=0),
                                      self.num_classes))
            label_weights.append(inside.float())
        labels, label_weights, pos, gt_idx = (torch.stack(t) for t in (
            labels, label_weights, pos, gt_idx))
        gt_box = torch.gather(gt_bboxes.float(), 1,
                              gt_idx[..., None].expand(-1, -1, 4))
        decoded = self.bbox_coder.decode(flat[None].expand(b, -1, -1),
                                         box_flat)
        with torch.no_grad():
            # each positive's joint loss (reference get_pos_loss :201)
            loss_c = self.loss_cls(cls_flat, labels, reduction_override='none',
                                   avg_factor=1.0).sum(-1)
            loss_b = self.loss_bbox(decoded, gt_box,
                                    reduction_override='none',
                                    avg_factor=1.0)
            pos_loss = torch.where(pos, loss_c + loss_b, INF)
            ci, cl, cv = paa_candidates(pos_loss, pos, gt_idx, g,
                                        [len(a) for a in anchors], self.topk)
            sel, reads = paa_select(cl, cv, em or gmm_em_1d)
            keep = paa_keep(ci, sel & gt_valid[..., None], n)
        labels = torch.where(pos & ~keep, self.num_classes, labels)
        return labels, label_weights, pos & keep, gt_box, decoded, reads

    def loss(self, cls_scores, bbox_preds, iou_preds, gt_bboxes, gt_valid,
             gt_labels, img_shapes, pad_shapes) -> Dict[str, torch.Tensor]:
        """loss_cls (over the positives, at least one an image), loss_bbox
        (on the decoded boxes, weighted by each positive's detached IoU with
        its gt and divided by their sum) and loss_iou (BCE of the IoU branch
        toward that IoU, over the positives)."""
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        b, c = gt_bboxes.shape[0], self.cls_out_channels
        cls_flat = torch.cat([s.float().reshape(b, -1, c)
                              for s in cls_scores], 1)
        box_flat = torch.cat([p.float().reshape(b, -1, 4)
                              for p in bbox_preds], 1)
        iou_flat = torch.cat([p.float().reshape(b, -1) for p in iou_preds], 1)
        labels, label_weights, pos, gt_box, decoded, _ = self.paa_targets(
            featmap_sizes, cls_flat, box_flat, gt_bboxes, gt_valid, gt_labels,
            img_shapes, pad_shapes)
        num_pos = pos.sum().float()
        loss_cls = self.loss_cls(
            cls_flat.reshape(-1, c), labels.reshape(-1),
            weight=label_weights.reshape(-1),
            avg_factor=num_pos.clamp(min=float(b)))
        iou_t = torch.where(pos, bbox_overlaps(decoded.detach(), gt_box,
                                               is_aligned=True), 0.0)
        loss_iou = self.loss_centerness(
            iou_flat.reshape(-1, 1), iou_t.reshape(-1, 1),
            weight=pos.reshape(-1).float(), avg_factor=num_pos.clamp(min=1.0))
        loss_bbox = self.loss_bbox(
            decoded.reshape(-1, 4), gt_box.reshape(-1, 4),
            weight=torch.where(pos, iou_t.clamp(min=EPS), 0.0).reshape(-1),
            avg_factor=iou_t.sum().clamp(min=EPS))
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_iou=loss_iou)

    # -------------------------------------------------------------- boxes
    def get_bboxes(self, cls_scores, bbox_preds, iou_preds, img_shapes,
                   scale_factors, cfg=None, rescale: bool = True,
                   with_nms: bool = True):
        """Per level the top ``nms_pre`` anchors by sqrt(best class score x
        IoU) (sigmoids), decoded and clipped to the image, divided by the
        scale factor with ``rescale``; then the multiclass NMS on those
        scores and, with ``score_voting``, each kept box replaced by the
        average of the same-class candidates over score_thr that overlap
        it by more than 0.01, weighted by exp(-(1 - IoU)^2 / 0.025) times
        their score. With ``with_nms=False`` the candidates (boxes (B, P,
        4), scores (B, P, C + 1) with a zero background column)."""
        cfg = dict(cfg or self.test_cfg)
        featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = self.prior_generator.grid_anchors(featmap_sizes,
                                                    cls_scores[0].device)
        nms_pre = cfg.get('nms_pre', -1)
        b, c = cls_scores[0].shape[0], self.cls_out_channels
        max_shape = img_shapes[:, None, :]
        mlvl_boxes, mlvl_scores = [], []
        for a, sc, bp, io in zip(anchors, cls_scores, bbox_preds, iou_preds):
            sc = torch.sigmoid(sc.reshape(b, -1, c).float())
            io = torch.sigmoid(io.reshape(b, -1).float())
            bp = bp.reshape(b, -1, 4).float()
            a = a[None].expand(b, -1, -1)
            sc = torch.sqrt(sc * io[..., None])
            if 0 < nms_pre < sc.shape[1]:
                _, top = fast_topk(sc.amax(-1), nms_pre)
                sc = torch.gather(sc, 1, top[..., None].expand(-1, -1, c))
                bp = torch.gather(bp, 1, top[..., None].expand(-1, -1, 4))
                a = torch.gather(a, 1, top[..., None].expand(-1, -1, 4))
            mlvl_boxes.append(self.bbox_coder.decode(a, bp,
                                                     max_shape=max_shape))
            mlvl_scores.append(sc)
        boxes = torch.cat(mlvl_boxes, 1)
        scores = torch.cat(mlvl_scores, 1)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        scores = torch.cat([scores, torch.zeros_like(scores[..., :1])], -1)
        if not with_nms:
            return boxes, scores
        thr = cfg['score_thr']
        res = multiclass_nms(boxes, scores, thr, dict(cfg['nms']),
                             cfg.get('max_per_img', 100))
        if not self.score_voting:
            return res
        # score voting (reference :606), every kept box at once
        labels = res.labels.clamp(min=0)
        cand = torch.gather(scores, 2, labels[:, None, :].expand(
            -1, scores.shape[1], -1)).transpose(1, 2)           # (B, K, P)
        iou = bbox_overlaps(res.dets[..., :4], boxes)           # (B, K, P)
        w = torch.exp(-(1 - iou) ** 2 / 0.025) * cand
        w = torch.where((iou > 0.01) & (cand > thr), w, 0.0)
        den = w.sum(-1, keepdim=True).clamp(min=EPS)
        voted = (w @ boxes) / den
        voted = torch.where((w.sum(-1) > 0)[..., None] & res.valid[..., None],
                            voted, res.dets[..., :4])
        return res._replace(dets=torch.cat([voted, res.dets[..., 4:5]], -1))
