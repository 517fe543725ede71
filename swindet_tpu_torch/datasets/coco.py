"""COCO dataset (counterpart of ``swindet_tpu/datasets/coco.py:24``;
reference mmdet/datasets/coco.py:21): image infos and annotations from a
COCO JSON, images without a usable annotation filtered, boxes xywh to
xyxy, crowd boxes to the ignore list, masks kept as raw polygons or RLE
for the pipeline; results to COCO json and their evaluation by COCOeval
(:123-270 there)."""
from __future__ import annotations

import contextlib
import io
import json
from collections import OrderedDict

import numpy as np

from ..core.class_names import COCO_CLASSES
from ..core.masks import mask_to_rle
from ..registries import DATASETS
from .api import COCO, COCOeval
from .custom import CustomDataset


@DATASETS.register_module()
class CocoDataset(CustomDataset):

    CLASSES = COCO_CLASSES

    def load_annotations(self, ann_file):
        self.coco = COCO(ann_file)
        self.cat_ids = self.coco.getCatIds(catNms=self.CLASSES)
        self.cat2label = {cat_id: i for i, cat_id in
                          enumerate(self.cat_ids)}
        self.img_ids = self.coco.getImgIds()
        data_infos = []
        for i in self.img_ids:
            info = self.coco.loadImgs([i])[0]
            info['filename'] = info['file_name']
            data_infos.append(info)
        return data_infos

    def get_ann_info(self, idx):
        img_id = self.data_infos[idx]['id']
        ann_ids = self.coco.getAnnIds(imgIds=[img_id])
        ann_info = self.coco.loadAnns(ann_ids)
        return self._parse_ann_info(self.data_infos[idx], ann_info)

    def get_cat_ids(self, idx):
        img_id = self.data_infos[idx]['id']
        ann_ids = self.coco.getAnnIds(imgIds=[img_id])
        return [ann['category_id'] for ann in
                self.coco.loadAnns(ann_ids)]

    def _filter_imgs(self, min_size=32):
        """Drop the images without an annotation of the dataset's classes
        (when ``filter_empty_gt``) or whose shorter side is under
        ``min_size``."""
        valid_inds = []
        ids_with_ann = set(a['image_id']
                           for a in self.coco.anns.values())
        ids_in_cat = set()
        for class_id in self.cat_ids:
            ids_in_cat |= set(self.coco.catToImgs[class_id])
        ids_in_cat &= ids_with_ann
        valid_img_ids = []
        for i, img_info in enumerate(self.data_infos):
            img_id = self.img_ids[i]
            if self.filter_empty_gt and img_id not in ids_in_cat:
                continue
            if min(img_info['width'], img_info['height']) >= min_size:
                valid_inds.append(i)
                valid_img_ids.append(img_id)
        self.img_ids = valid_img_ids
        return valid_inds

    def _parse_ann_info(self, img_info, ann_info):
        """xywh to xyxy; ignored, off-image, empty, sub-pixel and
        other-class annotations dropped; crowd boxes to the ignore list."""
        gt_bboxes, gt_labels, gt_bboxes_ignore, gt_masks_ann = [], [], [], []
        for ann in ann_info:
            if ann.get('ignore', False):
                continue
            x1, y1, w, h = ann['bbox']
            inter_w = max(0, min(x1 + w, img_info['width']) - max(x1, 0))
            inter_h = max(0, min(y1 + h, img_info['height']) - max(y1, 0))
            if inter_w * inter_h == 0:
                continue
            if ann['area'] <= 0 or w < 1 or h < 1:
                continue
            if ann['category_id'] not in self.cat_ids:
                continue
            bbox = [x1, y1, x1 + w, y1 + h]
            if ann.get('iscrowd', False):
                gt_bboxes_ignore.append(bbox)
            else:
                gt_bboxes.append(bbox)
                gt_labels.append(self.cat2label[ann['category_id']])
                gt_masks_ann.append(ann.get('segmentation', None))
        gt_bboxes = np.array(gt_bboxes, np.float32).reshape(-1, 4)
        gt_labels = np.array(gt_labels, np.int64).reshape(-1)
        gt_bboxes_ignore = np.array(gt_bboxes_ignore,
                                    np.float32).reshape(-1, 4)
        return dict(bboxes=gt_bboxes, labels=gt_labels,
                    bboxes_ignore=gt_bboxes_ignore,
                    masks=gt_masks_ann,
                    seg_map=img_info['filename'].replace('jpg', 'png'))

    # --------------------------------------------------------- results→json
    def xyxy2xywh(self, bbox):
        b = bbox.tolist()
        return [b[0], b[1], b[2] - b[0], b[3] - b[1]]

    def _det2json(self, results):
        json_results = []
        for idx in range(len(self)):
            img_id = self.img_ids[idx]
            result = results[idx]
            for label in range(len(result)):
                bboxes = result[label]
                for i in range(bboxes.shape[0]):
                    json_results.append(dict(
                        image_id=img_id,
                        bbox=self.xyxy2xywh(bboxes[i]),
                        score=float(bboxes[i][4]),
                        category_id=self.cat_ids[label]))
        return json_results

    def _segm2json(self, results):
        bbox_json, segm_json = [], []
        for idx in range(len(self)):
            img_id = self.img_ids[idx]
            det, seg = results[idx]
            for label in range(len(det)):
                bboxes = det[label]
                segms = seg[label]
                for i in range(bboxes.shape[0]):
                    data = dict(image_id=img_id,
                                bbox=self.xyxy2xywh(bboxes[i]),
                                score=float(bboxes[i][4]),
                                category_id=self.cat_ids[label])
                    bbox_json.append(data)
                    if i >= len(segms):
                        continue
                    m = segms[i]
                    if isinstance(m, np.ndarray):
                        m = mask_to_rle(m)
                    counts = m['counts']
                    if isinstance(counts, bytes):
                        m = dict(m, counts=counts.decode())
                    sdata = dict(data)
                    sdata['segmentation'] = m
                    segm_json.append(sdata)
        return bbox_json, segm_json

    def results2json(self, results, outfile_prefix):
        result_files = {}
        if isinstance(results[0], list):
            json_results = self._det2json(results)
            result_files['bbox'] = f'{outfile_prefix}.bbox.json'
            result_files['proposal'] = result_files['bbox']
            with open(result_files['bbox'], 'w') as f:
                json.dump(json_results, f)
        elif isinstance(results[0], tuple):
            bbox_json, segm_json = self._segm2json(results)
            result_files['bbox'] = f'{outfile_prefix}.bbox.json'
            result_files['proposal'] = result_files['bbox']
            result_files['segm'] = f'{outfile_prefix}.segm.json'
            with open(result_files['bbox'], 'w') as f:
                json.dump(bbox_json, f)
            with open(result_files['segm'], 'w') as f:
                json.dump(segm_json, f)
        else:
            raise TypeError('invalid type of results')
        return result_files

    # ------------------------------------------------------------ evaluate
    def evaluate(self, results, metric='bbox', logger=None,
                 jsonfile_prefix=None, classwise=False,
                 proposal_nums=(100, 300, 1000), iou_thrs=None,
                 metric_items=None, **kwargs):
        """COCO box, mask or proposal metrics of ``results`` (per image,
        in dataset order, as single_gpu_test gives them) by COCOeval
        (reference coco.py:346-546). Returns an OrderedDict of metrics."""
        metrics = metric if isinstance(metric, list) else [metric]
        allowed = ['bbox', 'segm', 'proposal', 'proposal_fast']
        for m in metrics:
            if m not in allowed:
                raise KeyError(f'metric {m} is not supported')

        # results to COCO json lists in memory (``results2json`` writes
        # the same lists to files)
        if isinstance(results[0], tuple):
            bbox_json, segm_json = self._segm2json(results)
            result_lists = {'bbox': bbox_json, 'proposal': bbox_json,
                            'segm': segm_json}
        else:
            det_json = self._det2json(results)
            result_lists = {'bbox': det_json, 'proposal': det_json}

        eval_results = OrderedDict()
        cocoGt = self.coco
        for m in metrics:
            iou_type = 'bbox' if m == 'proposal' else m
            if m not in result_lists:
                raise KeyError(f'{m} is not in results')
            res_list = result_lists[m]
            if len(res_list) == 0:
                eval_results[f'{m}_mAP'] = 0.0
                continue
            cocoDt = cocoGt.loadRes(res_list)
            cocoEval = COCOeval(cocoGt, cocoDt, iou_type)
            cocoEval.params.catIds = self.cat_ids
            cocoEval.params.imgIds = self.img_ids
            if iou_thrs is not None:
                cocoEval.params.iouThrs = np.asarray(iou_thrs)
            if m == 'proposal':
                cocoEval.params.useCats = 0
                cocoEval.params.maxDets = list(proposal_nums)
            cocoEval.evaluate()
            cocoEval.accumulate()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cocoEval.summarize()
            if logger is not None:
                logger.info('\n' + buf.getvalue())
            else:
                print(buf.getvalue())
            if m == 'proposal':
                keys = ['AR@100', 'AR@300', 'AR@1000', 'AR_s@1000',
                        'AR_m@1000', 'AR_l@1000']
                for i, k in enumerate(keys):
                    eval_results[k] = float(f'{cocoEval.stats[i + 6]:.4f}')
            else:
                names = ['mAP', 'mAP_50', 'mAP_75', 'mAP_s', 'mAP_m',
                         'mAP_l']
                for i, n in enumerate(names):
                    eval_results[f'{m}_{n}'] = float(
                        f'{cocoEval.stats[i]:.4f}')
                ap = cocoEval.stats[:6]
                eval_results[f'{m}_mAP_copypaste'] = (
                    f'{ap[0]:.4f} {ap[1]:.4f} {ap[2]:.4f} '
                    f'{ap[3]:.4f} {ap[4]:.4f} {ap[5]:.4f}')
                if classwise:
                    precisions = cocoEval.eval['precision']
                    for ci, catId in enumerate(self.cat_ids):
                        nm = self.coco.loadCats([catId])[0]
                        p = precisions[:, :, ci, 0, -1]
                        p = p[p > -1]
                        eval_results[f'{m}_AP_{nm["name"]}'] = (
                            float(np.mean(p)) if p.size else float('nan'))
        return eval_results
