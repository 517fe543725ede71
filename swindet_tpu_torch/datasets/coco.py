"""COCO dataset (counterpart of ``swindet_tpu/datasets/coco.py:24``;
reference mmdet/datasets/coco.py:21): image infos and annotations from a
COCO JSON, images without a usable annotation filtered, boxes xywh to
xyxy, crowd boxes to the ignore list, masks kept as raw polygons or RLE
for the pipeline."""
from __future__ import annotations

import numpy as np

from ..core.class_names import COCO_CLASSES
from ..registries import DATASETS
from .api import COCO
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

    def evaluate(self, results, metric='bbox', **kwargs):
        raise NotImplementedError(
            'CocoDataset.evaluate needs the COCOeval stack, which is not '
            'ported yet (ROADMAP §1 item 6)')
