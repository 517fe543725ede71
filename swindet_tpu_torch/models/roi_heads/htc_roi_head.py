"""Hybrid Task Cascade (counterpart of
``swindet_tpu/models/roi_heads/htc_roi_head.py``: ``FusedSemanticHead``
:31, its ``loss`` :87, ``HTCMaskHead`` :107, ``HybridTaskCascadeRoIHead``
:138, ``_fuse_semantic`` :158, ``_mask_flow_pred`` :167, ``forward_train``
:204, ``simple_test`` :337; reference mmdet/models/roi_heads/
htc_roi_head.py:11, mask_heads/fused_semantic_head.py:10,
mask_heads/htc_mask_head.py:8; arXiv:1901.07518).

The cascade of :class:`CascadeRoIHead` with three additions:

- a semantic branch (``FusedSemanticHead``): the five FPN levels, each
  through its 1x1 lateral conv, summed on the grid of level
  ``fusion_level`` (the others resized to it bilinearly with
  ``align_corners=True``), then ``num_convs`` 3x3 convs (norm-free at 256
  channels: the conv3x3 kernel), a 1x1 logits conv over the stuff classes
  and a 1x1 embedding conv. Its embedding, pooled by RoIAlign on its one
  stride-8 level at 14x14 (2x2-averaged to 7x7 for the bbox heads), is
  added to the bbox and mask roi features (``semantic_fusion``);
- interleaved training: each stage's mask branch samples again on that
  stage's refined boxes and trains on that sample's positives;
- mask information flow: stage i's mask head adds, through its 1x1
  ``conv_res``, the conv-tower output of the heads 0..i-1 run in a chain
  on the same roi features.

Test-time augmentation keeps the cascade's ``bbox_test`` and
``mask_test``, as the JAX package's HTC does: neither fuses the semantic
embedding nor chains the mask heads (mmdet's ``aug_test`` does both).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cascade_roi_head import CascadeRoIHead
from .mask_heads import FCNMaskHead
from .standard_roi_head import boxes_to_rois, mask_losses, sample_batch
from ..builder import build_head, build_roi_extractor
from ..layers import ConvModule, conv_nhwc, init_conv, resolve_dtype
from ..necks.nasfcos_fpn import resize_nearest_half_pixel
from ...registries import HEADS

_RELU = dict(type='ReLU')


def resize_bilinear_align_corners(x: torch.Tensor,
                                  shape: Tuple[int, int]) -> torch.Tensor:
    """NHWC ``x`` resized bilinearly to ``shape`` (H, W) with
    ``align_corners=True`` (output i samples input i * (in - 1) /
    (out - 1)), computed in fp32 and returned in ``x``'s dtype: the port's
    ``swindet_tpu/ops/interpolate.py:91``
    ``torch_bilinear_resize(align_corners=True)``."""
    if tuple(x.shape[1:3]) == tuple(shape):
        return x
    out = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(shape),
                        mode='bilinear', align_corners=True)
    return out.permute(0, 2, 3, 1).to(x.dtype)


@HEADS.register_module()
class FusedSemanticHead(nn.Module):
    """mmdet's names: ``lateral_convs.{i}.conv``, ``convs.{i}.conv``,
    ``conv_logits``, ``conv_embedding.conv``. ``conv_cfg`` is taken and
    not applied, as in the JAX head."""

    def __init__(self, num_ins: int = 5, fusion_level: int = 1,
                 num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 183,
                 ignore_label: int = 255, loss_weight: float = 0.2,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, conv_to_res: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if conv_to_res:
            raise NotImplementedError(
                'FusedSemanticHead: conv_to_res (SCNet\'s semantic head) is '
                'not ported (ROADMAP §1 slice 2e)')
        self.num_ins = num_ins
        self.fusion_level = fusion_level
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.loss_weight = loss_weight
        self.compute_dtype = resolve_dtype(dtype)
        self.lateral_convs = nn.ModuleList([
            ConvModule(in_channels, in_channels, 1, act_cfg=_RELU,
                       dtype=dtype) for _ in range(num_ins)])
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList([
            ConvModule(chans[i], chans[i + 1], 3, padding=1,
                       norm_cfg=norm_cfg, act_cfg=_RELU, dtype=dtype)
            for i in range(num_convs)])
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)
        self.conv_embedding = ConvModule(conv_out_channels, conv_out_channels,
                                         1, norm_cfg=norm_cfg, act_cfg=_RELU,
                                         dtype=dtype)

    def init_weights(self, gen: torch.Generator):
        for conv in list(self.lateral_convs) + list(self.convs) \
                + [self.conv_embedding]:
            conv.init_weights(gen)
        init_conv(self.conv_logits, gen)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level NHWC features -> (logits (B, H, W, num_classes),
        embedding (B, H, W, C)) on level ``fusion_level``'s grid."""
        x = self.lateral_convs[self.fusion_level](feats[self.fusion_level])
        hw = tuple(x.shape[1:3])
        for i, feat in enumerate(feats[:self.num_ins]):
            if i != self.fusion_level:
                x = x + self.lateral_convs[i](
                    resize_bilinear_align_corners(feat, hw))
        for conv in self.convs:
            x = conv(x)
        mask_pred = conv_nhwc(x, self.conv_logits, False, self.compute_dtype,
                              False)
        return mask_pred, self.conv_embedding(x)

    def loss(self, mask_pred: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Softmax cross-entropy over the pixels whose label is in [0,
        num_classes) and not ``ignore_label``, averaged over them (at
        least one) and scaled by ``loss_weight``. A label map (B, H', W')
        of another size than the logits' is first resized to theirs by
        half-pixel nearest sampling, as the JAX head's
        ``jax.image.resize`` does (mmdet has no such step)."""
        pred = mask_pred.float()
        labels = labels.long()
        if tuple(pred.shape[1:3]) != tuple(labels.shape[1:3]):
            labels = resize_nearest_half_pixel(labels, pred.shape[1:3])
        valid = (labels != self.ignore_label) & (labels >= 0) \
            & (labels < self.num_classes)
        safe = labels.clamp(0, self.num_classes - 1)
        ce = -torch.log_softmax(pred, -1).gather(-1, safe[..., None])[..., 0]
        ce = torch.where(valid, ce, 0.0)
        return self.loss_weight * ce.sum() / valid.sum().clamp(min=1)


@HEADS.register_module()
class HTCMaskHead(FCNMaskHead):
    """FCNMaskHead with a 1x1 ``conv_res`` (ReLU) that adds the previous
    stage's conv-tower output to the roi features before the convs."""

    def __init__(self, with_conv_res: bool = True,
                 conv_out_channels: int = 256, dtype=torch.float32,
                 **kwargs):
        super().__init__(conv_out_channels=conv_out_channels, dtype=dtype,
                         **kwargs)
        self.conv_res = ConvModule(conv_out_channels, conv_out_channels, 1,
                                   act_cfg=_RELU, dtype=dtype) \
            if with_conv_res else None

    def init_weights(self, gen: torch.Generator):
        super().init_weights(gen)
        if self.conv_res is not None:
            self.conv_res.init_weights(gen)

    def forward(self, x: torch.Tensor,
                res_feat: Optional[torch.Tensor] = None,
                return_logits: bool = True, return_feat: bool = False):
        """(R, 14, 14, C) roi features (and the previous stage's tower
        output ``res_feat``) -> the logits, the tower output (before the
        deconv), or both in that order."""
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = conv(x)
        outs = []
        if return_logits:
            outs.append(self.upsample_logits(x))
        if return_feat:
            outs.append(x)
        return tuple(outs) if len(outs) > 1 else outs[0]


@HEADS.register_module()
class HybridTaskCascadeRoIHead(CascadeRoIHead):

    def __init__(self, *args, semantic_roi_extractor: Optional[dict] = None,
                 semantic_head: Optional[dict] = None,
                 semantic_fusion: Sequence[str] = ('bbox', 'mask'),
                 interleaved: bool = True, mask_info_flow: bool = True,
                 dtype=torch.float32, **kwargs):
        super().__init__(*args, dtype=dtype, **kwargs)
        self.semantic_head = None
        if semantic_head is not None:
            self.semantic_roi_extractor = build_roi_extractor(
                dict(semantic_roi_extractor))
            self.semantic_head = build_head(dict(semantic_head, dtype=dtype))
        self.semantic_fusion = tuple(semantic_fusion)
        self.interleaved = interleaved
        self.mask_info_flow = mask_info_flow

    @property
    def with_semantic(self) -> bool:
        return self.semantic_head is not None

    def init_weights(self, gen: torch.Generator):
        super().init_weights(gen)
        if self.with_semantic:
            self.semantic_head.init_weights(gen)

    def _fusion(self, branch: str, sem_feat: Optional[torch.Tensor],
                roi_valid: Optional[torch.Tensor] = None):
        """The map (roi features, rois) -> roi features plus the semantic
        embedding pooled at the rois (RoIAlign on its one level, then a
        k x k average where the features are k times smaller), in the
        features' dtype; None where ``branch`` takes no fusion."""
        if sem_feat is None or branch not in self.semantic_fusion:
            return None

        def fuse(x, rois):
            sem = self.semantic_roi_extractor([sem_feat], rois,
                                              roi_valid=roi_valid)
            s, t = sem.shape[1], x.shape[1]
            if s != t:
                k = s // t
                sem = sem.view(sem.shape[0], t, k, t, k, sem.shape[-1]) \
                    .mean((2, 4))
            return x + sem.to(x.dtype)
        return fuse

    def _mask_flow_pred(self, stage: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``stage``'s mask logits: with the information flow, the
        heads 0..stage-1 first run in a chain, each on the previous one's
        tower output, and hand the last one's to it."""
        last = None
        if self.mask_info_flow:
            for i in range(stage):
                last = self.mask_head[i](x, last, return_logits=False,
                                         return_feat=True)
        return self.mask_head[stage](x, last)

    def forward_train(self, feats, proposals, proposal_valid, gt_bboxes,
                      gt_valid, gt_labels, gt_masks,
                      gen: Optional[torch.Generator] = None,
                      keys: Optional[Sequence] = None,
                      img_shapes: Optional[torch.Tensor] = None,
                      gt_semantic_seg: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """The cascade's arguments (see CascadeRoIHead.forward_train) and
        ``gt_semantic_seg`` (B, H', W') uint8 stuff labels, 255 ignored.
        ``keys``: per sampling call, in the order the head samples (each
        stage's bbox sample over its candidates, then, with
        ``interleaved`` and masks, its mask sample over the G + num
        refined boxes), per image the sampler's (keys_pos, keys_neg); or
        None to draw them from ``gen``."""
        losses: Dict[str, torch.Tensor] = {}
        sem_feat = None
        if self.with_semantic:
            sem_pred, sem_feat = self.semantic_head(feats)
            if gt_semantic_seg is not None:
                losses['loss_semantic_seg'] = self.semantic_head.loss(
                    sem_pred, gt_semantic_seg)
        calls = None if keys is None else iter(keys)

        def sample(stage, props, valid):
            return sample_batch(self.assigners[stage], self.samplers[stage],
                                props, valid, gt_bboxes, gt_valid, gt_labels,
                                gen, None if calls is None else next(calls))

        def mask_feats(fuse):
            def extract(feats, rois):
                x = self.mask_roi_extractor(feats, rois)
                return x if fuse is None else fuse(x, rois)
            return extract

        cur_props, cur_valid = proposals, proposal_valid
        for stage in range(self.num_stages):
            lw = self.stage_loss_weights[stage]
            head = self.bbox_head[stage]
            sampler = self.samplers[stage]
            samp = sample(stage, cur_props, cur_valid)
            rois = boxes_to_rois(samp.bboxes)
            valid = samp.valid.reshape(-1)
            x = self.bbox_roi_extractor(feats, rois, roi_valid=valid)
            fuse = self._fusion('bbox', sem_feat, valid)
            cls_score, bbox_pred = head(x if fuse is None else fuse(x, rois))
            labels, label_weights, bbox_targets, bbox_weights = \
                head.get_targets(samp, self.stage_cfgs[stage])
            labels = labels.reshape(-1)
            stage_losses = head.loss(
                cls_score, bbox_pred, rois, labels,
                label_weights.reshape(-1), bbox_targets.reshape(-1, 4),
                bbox_weights.reshape(-1, 4))
            for k, v in stage_losses.items():
                losses[f's{stage}.{k}'] = v * lw if 'loss' in k else v
            cur_props, cur_valid = self._refine(
                stage, samp, rois, labels, cls_score, bbox_pred, img_shapes,
                gt_bboxes.shape[1])

            if self.with_mask and gt_masks is not None:
                msamp = sample(stage, cur_props, cur_valid) \
                    if self.interleaved else samp
                mloss = mask_losses(
                    self.mask_head[stage],
                    mask_feats(self._fusion('mask', sem_feat)), feats, msamp,
                    int(sampler.num * sampler.pos_fraction), gt_masks,
                    self.stage_cfgs[stage].get('mask_size', 28),
                    predict=lambda x, s=stage: self._mask_flow_pred(s, x))
                losses[f's{stage}.loss_mask'] = mloss['loss_mask'] * lw
        return losses

    def simple_test(self, feats, proposals, proposal_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """The cascade's simple_test with the semantic embedding fused
        into every stage's bbox and mask features; the mask heads chain
        their tower outputs (information flow) and the stages' own
        sigmoids are averaged, with no accumulation of the logits."""
        sem_feat = self.semantic_head(feats)[1] if self.with_semantic \
            else None
        b, p = proposals.shape[:2]
        scores, rois, bbox_pred = self._ms_bbox_forward(
            feats, boxes_to_rois(proposals),
            img_shapes.repeat_interleave(p, 0),
            self._fusion('bbox', sem_feat))
        last = self.bbox_head[-1]
        boxes = last.decode_for_test(rois.view(b, p, 5),
                                     bbox_pred.view(b, p, -1), img_shapes)
        res = last.nms(scores.view(b, p, -1), boxes, scale_factors, rescale,
                       self.test_cfg, roi_valid=proposal_valid)
        out = dict(dets=res.dets, labels=res.labels, det_valid=res.valid)
        if self.with_mask:
            det_boxes = res.dets[..., :4]
            if rescale:  # the mask RoIAlign runs at input scale
                det_boxes = det_boxes * scale_factors[:, None, :4]
            m = det_boxes.shape[1]
            mask_rois = boxes_to_rois(det_boxes)
            x = self.mask_roi_extractor(feats, mask_rois)
            fuse = self._fusion('mask', sem_feat)
            if fuse is not None:
                x = fuse(x, mask_rois)
            labels = res.labels.reshape(-1)
            last_feat, probs = None, 0.0
            for head in self.mask_head:
                if self.mask_info_flow:
                    pred, last_feat = head(x, last_feat, return_feat=True)
                else:
                    pred = head(x)
                probs = probs + head.get_mask_probs(pred, labels)
            probs = probs / self.num_stages
            out['mask_probs'] = probs.view(b, m, *probs.shape[1:])
        return out
