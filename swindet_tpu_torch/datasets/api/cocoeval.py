"""COCO evaluation, a drop-in for pycocotools.cocoeval.COCOeval (a copy of
``swindet_tpu/datasets/api/cocoeval.py``): the COCO mAP protocol that
CocoDataset.evaluate runs (reference: mmdet/datasets/coco.py:346-546):
IoU thresholds .5:.05:.95, 101 recall points, area ranges, maxDets,
crowd-aware greedy matching, proposal (useCats=0) mode. The one change:
the segm IoU goes through the host library (``core/masks.py``
``rle_iou``), whose entries equal ``core/rle.py`` ``iou``'s bit for bit.

This file is a Python port of the evaluation protocol from
**pycocotools** (https://github.com/cocodataset/cocoapi,
pycocotools/cocoeval.py, (c) 2014 Piotr Dollar and Tsung-Yi Lin,
BSD-2-Clause license). The matching loop, accumulation index
arithmetic, and summarize() table must be bit-identical to the
upstream protocol for mAP numbers to be comparable, so the algorithm
is reproduced faithfully rather than redesigned. Redistribution of
the protocol implementation retains the upstream BSD-2-Clause terms:
redistributions must reproduce the above copyright notice, this list
of conditions and the following disclaimer — THE SOFTWARE IS PROVIDED
"AS IS" WITHOUT WARRANTY OF ANY KIND.
"""
from __future__ import annotations

import copy
import datetime
from collections import defaultdict

import numpy as np

from ...core.masks import rle_iou


def bbox_iou_xywh(dts: np.ndarray, gts: np.ndarray,
                  iscrowd) -> np.ndarray:
    """IoU matrix for [x,y,w,h] boxes; crowd gt → inter/det_area."""
    d, g = len(dts), len(gts)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    darea = dts[:, 2] * dts[:, 3]
    garea = gts[:, 2] * gts[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None]) - \
        np.maximum(dx1[:, None], gx1[None])
    ih = np.minimum(dy2[:, None], gy2[None]) - \
        np.maximum(dy1[:, None], gy1[None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    crowd = np.asarray(iscrowd, bool)
    union = np.where(crowd[None], darea[:, None],
                     darea[:, None] + garea[None] - inter)
    with np.errstate(divide='ignore', invalid='ignore'):
        out = np.where(union > 0, inter / union, 0.0)
    return out


class Params:
    def __init__(self, iouType='segm'):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(.5, 0.95,
                                   int(np.round((0.95 - .5) / .05)) + 1)
        self.recThrs = np.linspace(.0, 1.00,
                                   int(np.round((1.00 - .0) / .01)) + 1)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0 ** 2, 1e5 ** 2], [0 ** 2, 32 ** 2],
                        [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2]]
        self.areaRngLbl = ['all', 'small', 'medium', 'large']
        self.useCats = 1
        self.iouType = iouType


class COCOeval:

    def __init__(self, cocoGt=None, cocoDt=None, iouType='segm'):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.evalImgs = defaultdict(list)
        self.eval = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.params = Params(iouType=iouType)
        self._paramsEval = {}
        self.stats = []
        self.ious = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ----------------------------------------------------------- prepare
    def _prepare(self):
        p = self.params
        if p.useCats:
            gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(
                imgIds=p.imgIds, catIds=p.catIds))
            dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(
                imgIds=p.imgIds, catIds=p.catIds))
        else:
            gts = self.cocoGt.loadAnns(
                self.cocoGt.getAnnIds(imgIds=p.imgIds))
            dts = self.cocoDt.loadAnns(
                self.cocoDt.getAnnIds(imgIds=p.imgIds))
        if p.iouType == 'segm':
            for ann in gts:
                ann['rle'] = self.cocoGt.annToRLE(ann)
            for ann in dts:
                ann['rle'] = self.cocoDt.annToRLE(ann)
        for gt in gts:
            gt['ignore'] = gt.get('ignore', 0)
            gt['ignore'] = 'iscrowd' in gt and gt['iscrowd']  or gt['ignore']
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt['image_id'], gt['category_id']].append(gt)
        for dt in dts:
            self._dts[dt['image_id'], dt['category_id']].append(dt)
        self.evalImgs = defaultdict(list)
        self.eval = {}

    # ---------------------------------------------------------- evaluate
    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self.params = p
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {(imgId, catId): self.computeIoU(imgId, catId)
                     for imgId in p.imgIds for catId in catIds}
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds]
        self._paramsEval = copy.deepcopy(self.params)

    def computeIoU(self, imgId, catId):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [g for cId in p.catIds for g in self._gts[imgId, cId]]
            dt = [d for cId in p.catIds for d in self._dts[imgId, cId]]
        if len(gt) == 0 and len(dt) == 0:
            return []
        inds = np.argsort([-d['score'] for d in dt], kind='mergesort')
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[0:p.maxDets[-1]]
        iscrowd = [int(o.get('iscrowd', 0)) for o in gt]
        if p.iouType == 'segm':
            return rle_iou([d['rle'] for d in dt],
                           [g['rle'] for g in gt], iscrowd)
        d = np.array([dd['bbox'] for dd in dt], np.float64).reshape(-1, 4)
        g = np.array([gg['bbox'] for gg in gt], np.float64).reshape(-1, 4)
        return bbox_iou_xywh(d, g, iscrowd)

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [g for cId in p.catIds for g in self._gts[imgId, cId]]
            dt = [d for cId in p.catIds for d in self._dts[imgId, cId]]
        if len(gt) == 0 and len(dt) == 0:
            return None

        for g in gt:
            if g['ignore'] or (g['area'] < aRng[0] or g['area'] > aRng[1]):
                g['_ignore'] = 1
            else:
                g['_ignore'] = 0
        gtind = np.argsort([g['_ignore'] for g in gt], kind='mergesort')
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d['score'] for d in dt], kind='mergesort')
        dt = [dt[i] for i in dtind[0:maxDet]]
        iscrowd = [int(o.get('iscrowd', 0)) for o in gt]
        ious = self.ious[imgId, catId]
        ious = ious[:, gtind] if len(ious) > 0 else ious

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g['_ignore'] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) != 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]['id']
                    gtm[tind, m] = d['id']
        a = np.array([d['area'] < aRng[0] or d['area'] > aRng[1]
                      for d in dt]).reshape((1, len(dt)))
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(a, T, 0)))
        return {
            'image_id': imgId, 'category_id': catId, 'aRng': aRng,
            'maxDet': maxDet,
            'dtIds': [d['id'] for d in dt],
            'gtIds': [g['id'] for g in gt],
            'dtMatches': dtm, 'gtMatches': gtm,
            'dtScores': [d['score'] for d in dt],
            'gtIgnore': gtIg, 'dtIgnore': dtIg,
        }

    # -------------------------------------------------------- accumulate
    def accumulate(self, p=None):
        if not self.evalImgs:
            raise RuntimeError('Please run evaluate() first')
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        catIds = _pe.catIds if _pe.useCats else [-1]
        setK = set(catIds)
        setA = set(map(tuple, _pe.areaRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for n, m in enumerate(p.maxDets) if m in setM]
        a_list = [n for n, a in enumerate(map(lambda x: tuple(x),
                                              p.areaRng)) if a in setA]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e['dtScores'][0:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind='mergesort')
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e['dtMatches'][:, 0:maxDet] for e in E],
                        axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e['dtIgnore'][:, 0:maxDet] for e in E],
                        axis=1)[:, inds]
                    gtIg = np.concatenate([e['gtIgnore'] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        if nd:
                            recall[t, k, a, m] = rc[-1]
                        else:
                            recall[t, k, a, m] = 0
                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs,
                                                 side='left')
                        try:
                            for ri, pi in enumerate(inds_r):
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        except IndexError:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)
        self.eval = {
            'params': p,
            'counts': [T, R, K, A, M],
            'date': datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S'),
            'precision': precision,
            'recall': recall,
            'scores': scores,
        }

    # --------------------------------------------------------- summarize
    def summarize(self):
        def _summarize(ap=1, iouThr=None, areaRng='all', maxDets=100):
            p = self.params
            iStr = (' {:<18} {} @[ IoU={:<9} | area={:>6s} | '
                    'maxDets={:>3d} ] = {:0.3f}')
            titleStr = 'Average Precision' if ap == 1 else 'Average Recall'
            typeStr = '(AP)' if ap == 1 else '(AR)'
            iouStr = '{:0.2f}:{:0.2f}'.format(p.iouThrs[0], p.iouThrs[-1]) \
                if iouThr is None else '{:0.2f}'.format(iouThr)
            aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
            mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
            if ap == 1:
                s = self.eval['precision']
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, :, aind, mind]
            else:
                s = self.eval['recall']
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, aind, mind]
            if len(s[s > -1]) == 0:
                mean_s = -1
            else:
                mean_s = np.mean(s[s > -1])
            print(iStr.format(titleStr, typeStr, iouStr, areaRng,
                              maxDets, mean_s))
            return mean_s

        def _summarizeDets():
            stats = np.zeros((12,))
            stats[0] = _summarize(1)
            stats[1] = _summarize(1, iouThr=.5,
                                  maxDets=self.params.maxDets[2])
            stats[2] = _summarize(1, iouThr=.75,
                                  maxDets=self.params.maxDets[2])
            stats[3] = _summarize(1, areaRng='small',
                                  maxDets=self.params.maxDets[2])
            stats[4] = _summarize(1, areaRng='medium',
                                  maxDets=self.params.maxDets[2])
            stats[5] = _summarize(1, areaRng='large',
                                  maxDets=self.params.maxDets[2])
            stats[6] = _summarize(0, maxDets=self.params.maxDets[0])
            stats[7] = _summarize(0, maxDets=self.params.maxDets[1])
            stats[8] = _summarize(0, maxDets=self.params.maxDets[2])
            stats[9] = _summarize(0, areaRng='small',
                                  maxDets=self.params.maxDets[2])
            stats[10] = _summarize(0, areaRng='medium',
                                   maxDets=self.params.maxDets[2])
            stats[11] = _summarize(0, areaRng='large',
                                   maxDets=self.params.maxDets[2])
            return stats

        if not self.eval:
            raise RuntimeError('Please run accumulate() first')
        self.stats = _summarizeDets()

    def __str__(self):
        self.summarize()
        return ''
