"""Test-time augmentation (counterpart of ``swindet_tpu/apis/aug_test.py``:
``_flip_boxes_np``, ``map_boxes_back``, ``map_boxes_to_aug`` :32-80,
``aug_test_single_stage`` :88-134 and ``aug_test_two_stage`` :137-216;
reference mmdet roi_heads/test_mixins.py:118 aug_test_bboxes, :238
aug_test_mask, dense_test_mixins.py:60 aug_test_bboxes,
core/post_processing/merge_augs.py).

A single-stage detector's augmentations each give their pre-NMS
candidates, which are mapped back to the original frame, concatenated and
go through one multiclass NMS. For a two-stage detector:

Each augmentation (a scale and a flip) is one batch on its own canvas.
Its features are extracted once and handed to the detector's three
halves: the proposals of every augmentation, mapped back to the original
frame, are merged by one NMS; the bbox branch of every augmentation runs
on the merged proposals and its scores and boxes are averaged in the
original frame before one multiclass NMS; the mask branch of every
augmentation runs on the final detections and its probabilities,
flipped back, are averaged. Both NMS run on the model's device
(``core/nms.py``). Everything stays on the device: box mapping is
elementwise torch, in fp32 as the JAX package's numpy.

An augmentation batch is a dict: img (B, H, W, 3), img_shapes (B, 2),
scale_factors (B, 4) (tensors on the model's device), flip (bool) and
flip_direction (str). All augmentations of a call hold the same B images.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.nms import multiclass_nms, nms


def _flip_boxes(boxes: torch.Tensor, img_shapes: torch.Tensor,
                direction: str) -> torch.Tensor:
    """Flip (B, P, 4k) boxes inside each image's (h, w)."""
    out = boxes.clone()
    w = img_shapes[:, 1].float()[:, None, None]
    h = img_shapes[:, 0].float()[:, None, None]
    if direction in ('horizontal', 'diagonal'):
        out[..., 0::4] = w - boxes[..., 2::4]
        out[..., 2::4] = w - boxes[..., 0::4]
    if direction in ('vertical', 'diagonal'):
        out[..., 1::4] = h - boxes[..., 3::4]
        out[..., 3::4] = h - boxes[..., 1::4]
    return out


def _scaled(boxes: torch.Tensor, sf: torch.Tensor, inverse: bool):
    b, p = boxes.shape[:2]
    k = boxes.shape[-1] // 4
    boxes = boxes.reshape(b, p, k, 4)
    sf = sf.float()[:, None, None, :]
    return (boxes / sf if inverse else boxes * sf).reshape(b, p, 4 * k)


def map_boxes_back(boxes: torch.Tensor, aug_batch: Dict) -> torch.Tensor:
    """Augmentation frame -> original frame: un-flip in the augmentation's
    resized shape, then divide by its scale factor."""
    boxes = boxes.float()
    if aug_batch.get('flip'):
        boxes = _flip_boxes(boxes, aug_batch['img_shapes'],
                            aug_batch.get('flip_direction', 'horizontal'))
    return _scaled(boxes, aug_batch['scale_factors'], inverse=True)


def map_boxes_to_aug(boxes: torch.Tensor, aug_batch: Dict) -> torch.Tensor:
    """Original frame -> augmentation frame: multiply by the scale factor,
    then flip in the augmentation's resized shape."""
    boxes = _scaled(boxes.float(), aug_batch['scale_factors'],
                    inverse=False)
    if aug_batch.get('flip'):
        boxes = _flip_boxes(boxes, aug_batch['img_shapes'],
                            aug_batch.get('flip_direction', 'horizontal'))
    return boxes


def _unflip_masks(probs: torch.Tensor, aug_batch: Dict) -> torch.Tensor:
    if not aug_batch.get('flip'):
        return probs
    d = aug_batch.get('flip_direction', 'horizontal')
    dims = ([-1] if d in ('horizontal', 'diagonal') else []) \
        + ([-2] if d in ('vertical', 'diagonal') else [])
    return torch.flip(probs, dims)


def aug_test_single_stage(model, aug_batches: List[Dict]
                          ) -> Dict[str, torch.Tensor]:
    """The merged detections of a single-stage detector over
    ``aug_batches`` in the original frame: dets (B, max, 5), labels and
    det_valid. Every augmentation's candidates are concatenated, not
    averaged (there is no shared proposal set), and the NMS's entry cap
    grows with the number of augmentations, 2048 pairs each, so that the
    merge drops no candidate a single augmentation would have kept."""
    cfg = dict(model.test_cfg)
    boxes, scores = [], []
    for ab in aug_batches:
        b, s, factors = model.aug_bbox_test(ab['img'], ab['img_shapes'])
        if factors is not None:
            raise NotImplementedError('aug_test_single_stage: score '
                                      'factors are not ported yet')
        boxes.append(map_boxes_back(b, ab))
        scores.append(s.float())
    res = multiclass_nms(torch.cat(boxes, 1), torch.cat(scores, 1),
                         cfg['score_thr'], dict(cfg['nms']),
                         cfg.get('max_per_img', 100),
                         pre_nms_cap=2048 * len(aug_batches))
    return dict(dets=res.dets, labels=res.labels, det_valid=res.valid)


def aug_test_two_stage(model, aug_batches: List[Dict]
                       ) -> Dict[str, torch.Tensor]:
    """The merged detections of ``aug_batches`` in the original frame:
    dets (B, max, 5), labels, det_valid and, with a mask head, mask_probs
    (B, max, s, s), as ``simple_test`` with rescale gives them."""
    test_cfg = dict(model.test_cfg)
    rpn_cfg = dict(test_cfg['rpn'])
    rcnn_cfg = dict(test_cfg['rcnn'])
    rpn_iou = float(dict(rpn_cfg['nms'])['iou_threshold'])
    rpn_max = int(rpn_cfg.get('max_per_img', rpn_cfg.get('max_num', 1000)))
    n_aug = len(aug_batches)
    feats = [model.extract_feat(ab['img']) for ab in aug_batches]

    # 1. every augmentation's proposals in the original frame, merged
    props, scores, valid = [], [], []
    for ab, f in zip(aug_batches, feats):
        p, s, v = model.aug_rpn_test(ab['img'], ab['img_shapes'], feats=f)
        props.append(map_boxes_back(p, ab))
        scores.append(s.float())
        valid.append(v)
    merged = nms(torch.cat(props, 1), torch.cat(scores, 1), rpn_iou,
                 rpn_max, valid=torch.cat(valid, 1))
    proposals = merged.dets[..., :4]

    # 2. every augmentation's bbox branch on the merged proposals, averaged
    boxes_sum = scores_sum = None
    for ab, f in zip(aug_batches, feats):
        s, b = model.aug_bbox_test(ab['img'], map_boxes_to_aug(proposals, ab),
                                   ab['img_shapes'], feats=f)
        b = map_boxes_back(b, ab)
        boxes_sum = b if boxes_sum is None else boxes_sum + b
        scores_sum = s if scores_sum is None else scores_sum + s
    res = multiclass_nms(
        boxes_sum / n_aug,
        torch.where(merged.valid[..., None], scores_sum / n_aug, 0.0),
        rcnn_cfg['score_thr'], dict(rcnn_cfg['nms']),
        rcnn_cfg['max_per_img'])
    out = dict(dets=res.dets, labels=res.labels, det_valid=res.valid)

    # 3. every augmentation's mask branch on the final boxes, averaged
    if model.roi_head.with_mask:
        acc = None
        for ab, f in zip(aug_batches, feats):
            mp = model.aug_mask_test(ab['img'],
                                     map_boxes_to_aug(res.dets[..., :4], ab),
                                     res.labels, feats=f)
            mp = _unflip_masks(mp.float(), ab)
            acc = mp if acc is None else acc + mp
        out['mask_probs'] = acc / n_aug
    return out
