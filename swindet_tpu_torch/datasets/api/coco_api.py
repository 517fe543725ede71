"""COCO annotation index (counterpart of
``swindet_tpu/datasets/api/coco_api.py:19``, itself a drop-in for
pycocotools' ``COCO``): the JSON load, ``createIndex``, the queries,
``loadRes`` for detections and ``annToRLE`` / ``annToMask``, what
``COCOeval`` reads."""
from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, Optional, Union

import numpy as np

from ...core import rle as maskUtils
from ...core.masks import rle_area


class COCO:

    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            if not isinstance(self.dataset, dict):
                raise ValueError(f'{annotation_file}: not a COCO dict')
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns, catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get('annotations', []):
            imgToAnns[ann['image_id']].append(ann)
            anns[ann['id']] = ann
        for img in self.dataset.get('images', []):
            imgs[img['id']] = img
        for cat in self.dataset.get('categories', []):
            cats[cat['id']] = cat
        for ann in self.dataset.get('annotations', []):
            if 'category_id' in ann:
                catToImgs[ann['category_id']].append(ann['image_id'])
        self.anns, self.imgs, self.cats = anns, imgs, cats
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    @staticmethod
    def _as_list(x):
        return x if isinstance(x, (list, tuple, np.ndarray)) else [x]

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None):
        imgIds = self._as_list(imgIds)
        catIds = self._as_list(catIds)
        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get('annotations', [])
        else:
            if len(imgIds) > 0:
                anns = [a for i in imgIds for a in self.imgToAnns[i]]
            else:
                anns = self.dataset.get('annotations', [])
            if len(catIds) > 0:
                catset = set(catIds)
                anns = [a for a in anns if a['category_id'] in catset]
            if len(areaRng) > 0:
                anns = [a for a in anns
                        if areaRng[0] < a['area'] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get('iscrowd', 0) == iscrowd]
        return [a['id'] for a in anns]

    def getCatIds(self, catNms=(), supNms=(), catIds=()):
        catNms, supNms, catIds = map(self._as_list, (catNms, supNms, catIds))
        cats = self.dataset.get('categories', [])
        if len(catNms):
            cats = [c for c in cats if c['name'] in catNms]
        if len(supNms):
            cats = [c for c in cats if c.get('supercategory') in supNms]
        if len(catIds):
            cats = [c for c in cats if c['id'] in catIds]
        return [c['id'] for c in cats]

    def getImgIds(self, imgIds=(), catIds=()):
        imgIds = self._as_list(imgIds)
        catIds = self._as_list(catIds)
        if len(imgIds) == len(catIds) == 0:
            return list(self.imgs.keys())
        ids = set(imgIds) if len(imgIds) else set()
        for i, catId in enumerate(catIds):
            s = set(self.catToImgs[catId])
            ids = s if (i == 0 and not len(imgIds)) else (ids & s)
        return list(ids)

    def loadAnns(self, ids=()):
        return [self.anns[i] for i in self._as_list(ids)]

    def loadImgs(self, ids=()):
        return [self.imgs[i] for i in self._as_list(ids)]

    def loadCats(self, ids=()):
        return [self.cats[i] for i in self._as_list(ids)]

    # ------------------------------------------------------------- results
    def loadRes(self, resFile: Union[str, list]) -> 'COCO':
        """Detections (a json file or its list) -> a COCO of results over
        this one's images (pycocotools loadRes)."""
        res = COCO()
        res.dataset['images'] = list(self.dataset.get('images', []))
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = resFile
        if not isinstance(anns, list):
            raise TypeError('results must be a list of annotations')
        res.dataset['categories'] = copy.deepcopy(
            self.dataset.get('categories', []))
        if anns:
            if not {a['image_id'] for a in anns} <= set(self.getImgIds()):
                raise ValueError('Results do not correspond to current '
                                 'coco set')
            if 'bbox' in anns[0] and anns[0]['bbox'] != []:
                for aid, ann in enumerate(anns):
                    bb = ann['bbox']
                    if 'segmentation' not in ann:
                        x1, y1, w, h = bb
                        ann['segmentation'] = [[x1, y1, x1, y1 + h,
                                                x1 + w, y1 + h, x1 + w, y1]]
                    ann['area'] = bb[2] * bb[3]
                    ann['id'] = aid + 1
                    ann['iscrowd'] = 0
            elif 'segmentation' in anns[0]:
                for aid, ann in enumerate(anns):
                    ann['area'] = rle_area(ann['segmentation'])
                    if 'bbox' not in ann:
                        ann['bbox'] = maskUtils.to_bbox(
                            ann['segmentation']).tolist()
                    ann['id'] = aid + 1
                    ann['iscrowd'] = 0
        res.dataset['annotations'] = anns
        res.createIndex()
        return res

    # --------------------------------------------------------------- masks
    def annToRLE(self, ann):
        """An annotation's segmentation as compressed RLE."""
        img = self.imgs[ann['image_id']]
        h, w = img['height'], img['width']
        segm = ann['segmentation']
        if isinstance(segm, list):
            rles = maskUtils.frPyObjects(segm, h, w)
            return maskUtils.merge(rles if isinstance(rles, list)
                                   else [rles])
        if isinstance(segm['counts'], list):
            return maskUtils.frPyObjects(segm, h, w)
        return segm

    def annToMask(self, ann):
        return maskUtils.decode(self.annToRLE(ann))
