"""The port's evaluation stack against the JAX package's on the CPU: the
RLE codec (``core/rle.py``) bit for bit, the host library
(``csrc/rle_ops.cpp``) against its numpy versions bit for bit, the paste
against the JAX package's numpy paste, COCOeval's ``stats`` equal
(``==``) on identical inputs for bbox, segm, proposal and classwise, and
the ``results2json`` files equal as JSON."""
import copy
import json
import os

import numpy as np
import pytest

from swindet_tpu import native as jax_native
from swindet_tpu.core import masks as jax_masks
from swindet_tpu.core import rle as jax_rle
from swindet_tpu.datasets import CocoDataset as JaxCocoDataset
from swindet_tpu.datasets.api import COCO as JaxCOCO
from swindet_tpu.datasets.api import COCOeval as JaxCOCOeval

from tests.test_data.test_coco_dataset import _dummy_coco_json
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.core import host_ops, masks, rle
from swindet_tpu_torch.datasets import CocoDataset
from swindet_tpu_torch.datasets.api import COCO, COCOeval

cap_torch_threads()


def _mask(kind, h, w, rs):
    m = np.zeros((h, w), np.uint8)
    if kind == 'random':
        m = (rs.rand(h, w) > 0.6).astype(np.uint8)
    elif kind == 'full':
        m[:] = 1
    elif kind == 'pixel':
        m[rs.randint(h), rs.randint(w)] = 1
    elif kind == 'last':
        m[-1, -1] = 1
    elif kind == 'blob':
        y, x = np.ogrid[:h, :w]
        m = ((y - h / 2) ** 2 + (x - w / 3) ** 2 < (min(h, w) / 3) ** 2) \
            .astype(np.uint8)
    return m


MASK_CASES = [(k, h, w) for k in ('random', 'empty', 'full', 'pixel', 'last',
                                  'blob')
              for h, w in ((1, 1), (7, 13), (33, 1), (1, 40), (97, 131))]


@pytest.mark.parametrize('kind,h,w', MASK_CASES)
def test_rle_codec_matches_jax(kind, h, w):
    """encode, decode, area, to_bbox, the counts strings both ways, and
    the host library's codec, bit for bit."""
    rs = np.random.RandomState(h * 1000 + w)
    m = _mask(kind, h, w, rs)
    want = jax_rle.encode(m)
    got = rle.encode(m)
    assert got == want
    assert masks.mask_to_rle(m) == want
    assert masks.mask_to_rle(m.astype(bool)) == want
    counts = jax_rle.string_to_counts(want['counts'])
    assert np.array_equal(rle.string_to_counts(want['counts']), counts)
    assert np.array_equal(host_ops.rle_from_string(want['counts']), counts)
    assert host_ops.rle_to_string(counts) == want['counts']
    assert np.array_equal(host_ops.rle_encode(m), counts)
    assert np.array_equal(rle.decode(want), jax_rle.decode(want))
    assert np.array_equal(host_ops.rle_decode(counts, h, w), m.astype(bool))
    assert rle.area(want) == jax_rle.area(want) == masks.rle_area(want)
    assert np.array_equal(rle.to_bbox(want), jax_rle.to_bbox(want))
    # uncompressed counts and str counts take the same paths
    unc = {'size': [h, w], 'counts': counts.tolist()}
    assert rle.frPyObjects(unc, h, w) == jax_rle.frPyObjects(unc, h, w)
    assert masks.rle_area(dict(want, counts=want['counts'].decode())) \
        == jax_rle.area(want)


def _polygons(rs, h, w, n):
    out = []
    for _ in range(n):
        k = rs.randint(3, 9)
        cx, cy, r = rs.uniform(0, w), rs.uniform(0, h), rs.uniform(2, 30)
        ang = np.sort(rs.uniform(0, 2 * np.pi, k))
        rad = rs.uniform(0.3, 1.0, k) * r
        out.append(np.stack([cx + rad * np.cos(ang),
                             cy + rad * np.sin(ang)], 1).ravel()
                   .round(2).tolist())
    return out


@pytest.mark.parametrize('seed', range(4))
def test_fr_py_objects_merge_and_iou_match_jax(seed):
    """Polygons (some past the border), a box and uncompressed RLE through
    frPyObjects, merge (union and intersection), and the IoU matrix of
    the numpy codec and of the host library, crowd and not."""
    rs = np.random.RandomState(seed)
    h, w = 57 + seed * 11, 83 - seed * 7
    polys = _polygons(rs, h, w, 6)
    got, want = rle.frPyObjects(polys, h, w), jax_rle.frPyObjects(polys, h, w)
    assert got == want
    box = [3.5, 4.0, 20.2, 11.7]
    assert rle.frPyObjects(box, h, w) == jax_rle.frPyObjects(box, h, w)
    assert rle.frPyObjects(polys[0], h, w) == \
        jax_rle.frPyObjects(polys[0], h, w)
    for inter in (False, True):
        assert rle.merge(got[:3], inter) == jax_rle.merge(want[:3], inter)
    dts = want + [jax_rle.encode(_mask('random', h, w, rs))
                  for _ in range(3)]
    gts = want[::-1] + [jax_rle.encode(_mask('empty', h, w, rs))]
    crowd = rs.rand(len(gts)) > 0.5
    ref = jax_rle.iou(dts, gts, crowd)
    assert ref.max() > 0
    assert np.array_equal(rle.iou(dts, gts, crowd), ref)
    assert np.array_equal(masks.rle_iou(dts, gts, crowd), ref)
    assert np.array_equal(masks.rle_iou(dts, gts, crowd),
                          jax_masks.rle_iou(dts, gts, crowd))
    assert masks.rle_iou(dts, [], []).shape == (len(dts), 0)


@pytest.mark.parametrize('seed', range(3))
def test_paste_library_matches_numpy_and_jax(monkeypatch, seed):
    """The library's paste equals the port's numpy paste and the JAX
    package's numpy paste bit for bit: boxes inside, across and past
    the border, slivers and degenerate boxes."""
    rs = np.random.RandomState(seed)
    n, s, h, w = 40, 28, 90, 117
    xy = rs.uniform(-30, 110, (n, 2))
    wh = rs.uniform(0.3, 70, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[0] = [10, 10, 10, 30]             # zero width
    boxes[1] = [200, 5, 230, 40]            # off the image
    boxes[2] = [5.25, 7.5, 6.0, 60.0]       # sub-pixel sliver
    probs = rs.rand(n, s, s).astype(np.float32)
    got = masks.paste_masks(probs, boxes, h, w, 0.5)
    want = masks.paste_masks_reference(probs, boxes, h, w, 0.5)
    assert got.dtype == bool and got.shape == (n, h, w)
    assert 0 < got.sum() and np.array_equal(got, want)
    monkeypatch.setattr(jax_native, 'available', lambda: False)
    assert np.array_equal(got, jax_masks.paste_masks(probs, boxes, h, w, 0.5))
    sampled = masks.paste_masks_reference(probs, boxes, h, w, probs=True)
    assert np.array_equal(sampled >= 0.5, got)
    assert masks.paste_masks(probs[:0], boxes[:0], h, w).shape == (0, h, w)


# ----------------------------------------------------------------- COCOeval
def _seeded_coco(path, n_img=20, seed=0):
    """A COCO json of ``n_img`` images, 3 categories, polygons of all area
    ranges, crowd gts as uncompressed RLE and some gts marked ignore."""
    rs = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(1, n_img + 1):
        h, w = int(rs.randint(150, 260)), int(rs.randint(150, 260))
        images.append(dict(id=i, file_name=f'{i}.png', height=h, width=w))
        for _ in range(rs.randint(0, 7)):
            crowd = rs.rand() < 0.15
            r = rs.choice([4, 12, 40, 70])
            cx, cy = rs.uniform(r, w - r), rs.uniform(r, h - r)
            if crowd:
                m = np.zeros((h, w), np.uint8)
                m[int(cy - r):int(cy + r), int(cx - r):int(cx + r)] = 1
                enc = jax_rle.encode(m)
                segm = dict(size=[h, w], counts=jax_rle.string_to_counts(
                    enc['counts']).tolist())
                bbox = jax_rle.to_bbox(enc).tolist()
                area = float(m.sum())
            else:
                k = rs.randint(3, 9)
                ang = np.sort(rs.uniform(0, 2 * np.pi, k))
                rad = rs.uniform(0.5, 1.0, k) * r
                poly = np.stack([cx + rad * np.cos(ang),
                                 cy + rad * np.sin(ang)], 1)
                segm = [poly.ravel().round(2).tolist()]
                x1, y1 = poly.min(0)
                x2, y2 = poly.max(0)
                bbox = [float(x1), float(y1), float(x2 - x1),
                        float(y2 - y1)]
                area = float(bbox[2] * bbox[3] * 0.7)
            ann = dict(id=len(anns) + 1, image_id=i,
                       category_id=int(rs.randint(1, 4)), bbox=bbox,
                       area=area, iscrowd=int(crowd), segmentation=segm)
            if rs.rand() < 0.05:
                ann['ignore'] = 1
            anns.append(ann)
    cats = [dict(id=k, name=n) for k, n in ((1, 'person'), (2, 'bicycle'),
                                            (3, 'car'))]
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return images, anns


def _seeded_results(images, anns, seed=1, n_classes=3):
    """Per image, per class, detections near the gts (shifted, rescaled)
    and random ones, with tied scores; masks are the shifted gt masks."""
    rs = np.random.RandomState(seed)
    coco = JaxCOCO()
    coco.dataset = dict(images=images, annotations=anns, categories=[])
    coco.createIndex()
    results = []
    for img in images:
        h, w = img['height'], img['width']
        dets = [[] for _ in range(n_classes)]
        segs = [[] for _ in range(n_classes)]
        for a in coco.imgToAnns[img['id']]:
            for _ in range(rs.randint(0, 3)):
                x, y, bw, bh = a['bbox']
                dx, dy = rs.normal(0, 0.1 * bw), rs.normal(0, 0.1 * bh)
                sc = rs.uniform(0.8, 1.2)
                b = [x + dx, y + dy, x + dx + bw * sc, y + dy + bh * sc]
                lab = a['category_id'] - 1 if rs.rand() < 0.8 else \
                    int(rs.randint(n_classes))
                m = jax_rle.decode(coco.annToRLE(a))
                m = np.roll(m, (int(round(dy)), int(round(dx))), (0, 1))
                dets[lab].append(b + [round(rs.rand(), 2)])
                segs[lab].append(m.astype(bool))
        for _ in range(rs.randint(0, 4)):
            x, y = rs.uniform(0, w - 20), rs.uniform(0, h - 20)
            bw, bh = rs.uniform(5, 80, 2)
            lab = int(rs.randint(n_classes))
            m = np.zeros((h, w), bool)
            m[int(y):int(y + bh), int(x):int(x + bw)] = True
            dets[lab].append([x, y, x + bw, y + bh, round(rs.rand(), 2)])
            segs[lab].append(m)
        results.append(([np.array(d, np.float32).reshape(-1, 5)
                         for d in dets], segs))
    return results


@pytest.fixture(scope='module')
def seeded(tmp_path_factory):
    root = tmp_path_factory.mktemp('cocoeval')
    path = str(root / 'ann.json')
    images, anns = _seeded_coco(path)
    return path, str(root), _seeded_results(images, anns)


@pytest.fixture
def dummy(tmp_path):
    path = str(tmp_path / 'ann.json')
    _dummy_coco_json(path, str(tmp_path))
    return path, str(tmp_path)


def _datasets(path, prefix, classes):
    return (CocoDataset(ann_file=path, pipeline=[], classes=classes,
                        img_prefix=prefix, test_mode=True),
            JaxCocoDataset(ann_file=path, pipeline=[], classes=classes,
                           img_prefix=prefix, test_mode=True))


def _dummy_results(ds, kind):
    """The half-correct, perfect and wrong detections of
    tests/test_data/test_coco_dataset.py, with the gts' own masks (a box
    mask for a wrong detection)."""
    out = []
    for i in range(len(ds)):
        anns = ds.coco.loadAnns(ds.coco.getAnnIds(imgIds=[ds.img_ids[i]]))
        b = ds.get_ann_info(i)['bboxes']
        ms = [ds.coco.annToMask(a).astype(bool) for a in anns]
        if kind == 'half':
            b, ms = b[:1], ms[:1]
        elif kind == 'wrong':
            b = np.array([[40, 40, 45, 45]], np.float32)
            ms = [np.zeros((48, 64), bool)]
            ms[0][40:45, 40:45] = True
        dets = np.hstack([b, np.full((len(b), 1), 0.9, np.float32)])
        out.append(([dets, np.zeros((0, 5), np.float32)], [ms, []]))
    return out


@pytest.mark.parametrize('iou_type,use_cats', [('bbox', 1), ('segm', 1),
                                               ('bbox', 0)])
def test_cocoeval_stats_equal_jax(seeded, iou_type, use_cats):
    """COCOeval on identical inputs: stats, precision and recall arrays
    equal exactly (proposal mode: useCats 0, maxDets 100/300/1000)."""
    path, prefix, results = seeded
    port, jax_ds = _datasets(path, prefix, ('person', 'bicycle', 'car'))
    bbox_json, segm_json = port._segm2json(results)
    dets = bbox_json if iou_type == 'bbox' else segm_json
    stats = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JaxCOCO, JaxCOCOeval)):
        gt = coco_cls(path)
        ev = eval_cls(gt, gt.loadRes(copy.deepcopy(dets)), iou_type)
        if not use_cats:
            ev.params.useCats = 0
            ev.params.maxDets = [100, 300, 1000]
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        stats.append((ev.stats, ev.eval['precision'], ev.eval['recall']))
    (s, p, r), (s_j, p_j, r_j) = stats
    assert (s == s_j).all() and s[0] > 0.05, (s, s_j)
    assert np.array_equal(p, p_j) and np.array_equal(r, r_j)


@pytest.mark.parametrize('case', ['seeded', 'half', 'perfect', 'wrong'])
def test_coco_evaluate_equals_jax(seeded, dummy, case):
    """CocoDataset.evaluate, bbox, segm and proposal with classwise, gives
    the JAX package's metrics exactly; the fixture's cases read their
    known values."""
    if case == 'seeded':
        path, prefix, results = seeded
        classes = ('person', 'bicycle', 'car')
    else:
        path, prefix = dummy
        classes = ('person', 'bicycle')
    port, jax_ds = _datasets(path, prefix, classes)
    if case != 'seeded':
        results = _dummy_results(port, case)
    metric = ['bbox', 'segm', 'proposal']
    got = port.evaluate(copy.deepcopy(results), metric=metric,
                        classwise=True)
    want = jax_ds.evaluate(copy.deepcopy(results), metric=metric,
                           classwise=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    expect = dict(half=0.5, perfect=1.0, wrong=0.0).get(case)
    if expect is not None:
        assert got['bbox_mAP'] == pytest.approx(expect, abs=0.01)
        assert got['segm_mAP'] == pytest.approx(expect, abs=0.01)
    # box results alone (no masks) take _det2json
    boxes = [r[0] for r in results]
    assert port.evaluate(boxes, metric='bbox') == \
        jax_ds.evaluate(boxes, metric='bbox')


def test_results2json_equals_jax(seeded, tmp_path):
    path, prefix, results = seeded
    port, jax_ds = _datasets(path, prefix, ('person', 'bicycle', 'car'))
    for results_ in (results, [r[0] for r in results]):
        got = port.results2json(results_, str(tmp_path / 'port'))
        want = jax_ds.results2json(results_, str(tmp_path / 'jax'))
        assert sorted(got) == sorted(want)
        for k in got:
            with open(got[k]) as f, open(want[k]) as g:
                a, b = json.load(f), json.load(g)
            assert a == b and len(a) > 50, k
            assert isinstance(a[0]['bbox'][0], float)
            if k == 'segm':
                assert isinstance(a[0]['segmentation']['counts'], str)
                assert os.path.basename(got[k]) == 'port.segm.json'
    assert 'segm' not in got
