"""The port's host side of training against the JAX package, on the CPU,
with inputs made from seeds: the polygon fill and RLE decode, the mask
resize, the image decoder, the COCO dataset, the flagship's train
pipeline, the sampler, the canvas, the collate and the bias-table
resize. Everything is exact but the JPEG decode (within 1 LSB of cv2,
libjpeg's own rounding) and the bias table (bicubic in float, 1e-5 of its
largest entry)."""
import copy
import json
import os

import cv2
import numpy as np
import pytest
import torch

from swindet_tpu.checkpoint import _interp_bias_table
from swindet_tpu.core.masks import mask_to_rle
from swindet_tpu.core.masks import poly2mask as jax_poly2mask
from swindet_tpu.core.masks import rle_to_mask as jax_rle_to_mask
from swindet_tpu.datasets import CocoDataset as JaxCocoDataset
from swindet_tpu.datasets.builder import GroupBatchSampler as JaxSampler
from swindet_tpu.datasets.builder import collate_detection as jax_collate
from swindet_tpu.datasets.builder import derive_canvas as jax_derive_canvas
from swindet_tpu.datasets.pipelines import Compose as JaxCompose
from swindet_tpu.utils import Config as JaxConfig

from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import interp_bias_table
from swindet_tpu_torch.core.masks import poly2mask, rle_to_mask
from swindet_tpu_torch.datasets import (CocoDataset, GroupBatchSampler,
                                        collate_detection, derive_canvas)
from swindet_tpu_torch.datasets.image_io import imread, unfilter
from swindet_tpu_torch.datasets.pipelines import Compose, imresize_nearest

from chip_smoke import png_bytes

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(
    REPO, 'configs/swin/'
    'mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py')
POLY_KINDS = ('concave', 'self_intersecting', 'several', 'off_image',
              'fractional')


def _random_polygons(rs, kind, h, w):
    """One object's polygons of ``kind``."""
    if kind == 'concave':
        k = rs.randint(5, 12)
        ang = np.sort(rs.uniform(0, 2 * np.pi, k))
        rad = rs.uniform(0.2, 1.0, k) * min(h, w) / 2
        pts = np.stack([w / 2 + rad * np.cos(ang),
                        h / 2 + rad * np.sin(ang)], 1).round()
        return [pts.ravel().tolist()]
    if kind == 'self_intersecting':
        k = rs.randint(4, 10)   # points in random order cross each other
        return [np.stack([rs.randint(0, w, k), rs.randint(0, h, k)], 1)
                .astype(float).ravel().tolist()]
    if kind == 'several':
        return [np.stack([rs.uniform(0, w, k), rs.uniform(0, h, k)], 1)
                .round().ravel().tolist()
                for k in rs.randint(3, 8, rs.randint(2, 5))]
    if kind == 'off_image':
        k = rs.randint(3, 10)
        return [np.stack([rs.uniform(-0.6, 1.6, k) * w,
                          rs.uniform(-0.6, 1.6, k) * h], 1)
                .round().ravel().tolist()]
    k = rs.randint(3, 10)
    return [np.stack([rs.uniform(-0.1, 1.1, k) * w,
                      rs.uniform(-0.1, 1.1, k) * h], 1).ravel().tolist()]


@pytest.mark.parametrize('kind', POLY_KINDS)
def test_poly2mask_equals_jax_bit_for_bit(kind):
    """40 seeded objects of each kind (200 in all), on images of 1 to 96
    pixels a side, against the JAX package's cv2.fillPoly."""
    rs = np.random.RandomState(POLY_KINDS.index(kind))
    filled = 0
    for _ in range(40):
        h, w = (int(v) for v in rs.randint(1, 97, 2))
        polys = _random_polygons(rs, kind, h, w)
        got = poly2mask(polys, h, w)
        want = jax_poly2mask(polys, h, w)
        assert got.dtype == want.dtype and np.array_equal(got, want), \
            (kind, h, w, polys)
        filled += int(want.sum())
    assert filled > 0


def test_rle_to_mask_is_exact():
    rs = np.random.RandomState(0)
    for h, w in ((1, 1), (7, 5), (48, 64), (100, 37)):
        mask = rs.rand(h, w) < rs.uniform(0.05, 0.95)
        rle = mask_to_rle(mask)
        for r in (rle, dict(rle, counts=rle['counts'].decode())):
            assert np.array_equal(rle_to_mask(r), mask)
            assert np.array_equal(rle_to_mask(r), jax_rle_to_mask(r))
    # uncompressed counts, ending short of the image
    r = {'size': [4, 3], 'counts': [2, 3, 1, 4]}
    assert np.array_equal(rle_to_mask(r), jax_rle_to_mask(r))


@pytest.mark.parametrize('src,dst', [((48, 64), (96, 128)),
                                     ((100, 37), (61, 23)),
                                     ((333, 500), (800, 1201)),
                                     ((7, 5), (7, 5)), ((1, 9), (13, 2))])
def test_mask_nearest_resize_equals_cv2(src, dst):
    rs = np.random.RandomState(sum(src))
    masks = (rs.rand(3, *src) < 0.5).astype(np.uint8)
    got = imresize_nearest(masks, dst[::-1])
    for m, g in zip(masks, got):
        assert np.array_equal(g, cv2.resize(m, dst[::-1],
                                            interpolation=cv2.INTER_NEAREST))


def test_png_decoder_equals_cv2(tmp_path):
    """cv2-written PNGs (BGR, gray, BGRA; compression 0, 3 and 9, which
    choose their row filters) and PNGs written with each of the five row
    filters, against cv2.imread."""
    rs = np.random.RandomState(0)
    for c in (3, 1, 4):
        img = rs.randint(0, 256, (37, 53, c)).astype(np.uint8)
        img[:, :20] = img[:, :1]
        img = img[..., 0] if c == 1 else img
        for level in (0, 3, 9):
            path = str(tmp_path / f'{c}_{level}.png')
            cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert np.array_equal(imread(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))
    img = rs.randint(0, 256, (29, 41, 3)).astype(np.uint8)
    img[10:20] = np.arange(41)[:, None] * 5     # rows that favour Sub
    # each of the five filters on every row, then libpng's choice per row
    for filt in (0, 1, 2, 3, 4, None):
        path = str(tmp_path / f'filter{filt}.png')
        with open(path, 'wb') as f:
            f.write(png_bytes(img, filter_type=filt))
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)
        assert np.array_equal(imread(path), img)


def _unfilter_bytewise(rows, bpp):
    """PNG's row filters undone byte by byte, as the specification
    states them."""
    out = np.zeros((rows.shape[0], rows.shape[1] - 1), np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        for i, x in enumerate(row[1:]):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if y and i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(
                p - c) else b if abs(p - b) <= abs(p - c) else c
            out[y, i] = (x + (0, a, b, (a + b) >> 1, paeth)[row[0]]) & 0xff
    return out.astype(np.uint8)


@pytest.mark.parametrize('h,w,bpp', [(1, 1, 3), (1, 9, 1), (7, 1, 4),
                                     (9, 13, 2), (13, 9, 3)])
def test_png_unfilter_mixed_rows_equals_the_bytewise_rule(h, w, bpp):
    """Rows of mixed filter types, with and without Average and Paeth
    rows (the diagonal sweep and the row by row path)."""
    rs = np.random.RandomState(h * 100 + w * 10 + bpp)
    for kinds in (rs.randint(0, 5, h), rs.randint(0, 3, h)):
        rows = rs.randint(0, 256, (h, w * bpp + 1)).astype(np.uint8)
        rows[:, 0] = kinds
        assert np.array_equal(unfilter(rows, bpp),
                              _unfilter_bytewise(rows, bpp))


def test_jpeg_decoder_within_one_lsb_of_cv2(tmp_path):
    """Built here with libjpeg: within 1 of cv2.imread everywhere; the
    share of pixels that differ is printed."""
    rs = np.random.RandomState(1)
    shares = []
    for i, (h, w) in enumerate(((37, 53), (64, 48), (120, 90))):
        img = cv2.GaussianBlur(rs.randint(0, 256, (h, w, 3)).astype(
            np.uint8), (5, 5), 0)
        path = str(tmp_path / f'{i}.jpg')
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        got = imread(path).astype(int)
        want = cv2.imread(path, cv2.IMREAD_COLOR).astype(int)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1
        shares.append(float((got != want).mean()))
    print(f'JPEG: share of values 1 LSB from cv2: {shares}')


def test_imread_refuses_other_formats(tmp_path):
    path = tmp_path / 'x.bmp'
    path.write_bytes(b'BM' + bytes(60))
    with pytest.raises(ValueError, match='neither PNG nor JPEG'):
        imread(str(path))


# ------------------------------------------------------------------ COCO
def _dummy_coco(tmp_path):
    """Three 48x64 images and one 40x30 image with annotations that are
    kept, crowd, ignored, tiny, off the image and of a category outside
    the classes, and one image with none (modelled on
    tests/test_data/test_coco_dataset.py:13)."""
    rs = np.random.RandomState(0)
    images, anns = [], []
    for i, (h, w) in enumerate(((48, 64), (48, 64), (48, 64), (40, 30)),
                               start=1):
        name = f'img{i}.png'
        cv2.imwrite(str(tmp_path / name),
                    rs.randint(0, 255, (h, w, 3), np.uint8))
        images.append(dict(id=i, file_name=name, width=w, height=h))
    box = [[4.5, 5.0, 20.25, 15.5], [30.0, 20.0, 14.0, 12.0]]

    def add(img, bbox, cat=1, **kw):
        x, y, bw, bh = bbox
        anns.append(dict(dict(id=len(anns) + 1, image_id=img,
                              category_id=cat, bbox=bbox, area=bw * bh,
                              iscrowd=0,
                              segmentation=[[x, y, x + bw, y, x + bw,
                                             y + bh, x, y + bh]]), **kw))
    for img in (1, 2):
        add(img, box[0], cat=1)
        add(img, box[1], cat=2)
    add(1, [10, 10, 20, 20], iscrowd=1)           # crowd -> ignore list
    add(1, [1, 1, 5, 5], ignore=True)              # ignored
    add(2, [3, 3, 0.5, 9])                         # narrower than 1 px
    add(2, [70, 50, 10, 10])                       # off the image
    add(2, [5, 5, 10, 10], cat=3)                  # not of the classes
    add(3, [5, 5, 10, 10], cat=3)                  # only other classes
    add(4, box[0], cat=2)                          # image of 30 px wide
    data = dict(images=images + [dict(id=5, file_name='none.png', width=64,
                                      height=48)],
                annotations=anns,
                categories=[dict(id=1, name='person'),
                            dict(id=2, name='bicycle'),
                            dict(id=3, name='car')])
    path = str(tmp_path / 'ann.json')
    with open(path, 'w') as f:
        json.dump(data, f)
    return path


@pytest.mark.parametrize('min_size_filter', [True, False])
def test_coco_dataset_equals_jax(tmp_path, min_size_filter):
    """data_infos, flag and every ann_info; with filter_empty_gt off the
    image without annotations and the one of other classes stay."""
    ann_file = _dummy_coco(tmp_path)
    kw = dict(ann_file=ann_file, pipeline=[], img_prefix=str(tmp_path),
              classes=('person', 'bicycle'),
              filter_empty_gt=min_size_filter)
    port, jax_ds = CocoDataset(**kw), JaxCocoDataset(**kw)
    assert port.data_infos == jax_ds.data_infos and len(port) > 0
    assert np.array_equal(port.flag, jax_ds.flag)
    assert port.img_ids == jax_ds.img_ids
    for i in range(len(port)):
        a, b = port.get_ann_info(i), jax_ds.get_ann_info(i)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
        assert port.get_cat_ids(i) == jax_ds.get_cat_ids(i)
    # evaluation is ported: the gts as detections score as in the JAX
    # package
    results = [[np.hstack([port.get_ann_info(i)['bboxes'],
                           np.ones((len(port.get_ann_info(i)['bboxes']), 1),
                                   np.float32)]),
                np.zeros((0, 5), np.float32)] for i in range(len(port))]
    assert port.evaluate(results, metric='bbox') == \
        jax_ds.evaluate(results, metric='bbox')


# -------------------------------------------------------------- pipeline
def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


@pytest.fixture(scope='module')
def pipeline_sample(tmp_path_factory):
    """A 48x64 PNG with three polygon objects, one concave, and its
    annotation."""
    d = tmp_path_factory.mktemp('pipe')
    rs = np.random.RandomState(0)
    cv2.imwrite(str(d / 'a.png'), rs.randint(0, 256, (48, 64, 3),
                                              np.uint8))
    ann = dict(
        bboxes=np.array([[4.2, 4.1, 30.2, 30.5], [40, 10, 60, 40],
                         [1, 1, 10, 8]], np.float32),
        labels=np.array([1, 2, 3]),
        bboxes_ignore=np.zeros((0, 4), np.float32),
        masks=[[[5.3, 4.1, 30.2, 6.7, 28.9, 30.5, 15.5, 12.0, 4.2, 25.0]],
               [[40, 10, 60, 10, 60, 40, 40, 40]],
               [[1, 1, 10, 1, 10, 8]]])
    return str(d), ann


def _run_both(steps, sample, seed):
    prefix, ann = sample
    out = []
    for pipe in (JaxCompose(copy.deepcopy(steps)),
                 Compose(copy.deepcopy(steps))):
        results = dict(img_info=dict(filename='a.png', height=48, width=64),
                       ann_info=copy.deepcopy(ann), img_prefix=prefix,
                       bbox_fields=[], mask_fields=[], seg_fields=[],
                       _rng=np.random.RandomState(seed))
        out.append(pipe(results))
    return out


def test_flagship_train_pipeline_equals_jax(pipeline_sample):
    """The flagship config's train pipeline, unchanged (flip, both
    AutoAugment branches with the crop), on 20 seeds: image, boxes,
    labels, masks and the metas bit for bit."""
    steps = _plain([dict(s) for s in
                    JaxConfig.fromfile(CONFIG).data.train.pipeline])
    flips, sizes, dropped = set(), set(), 0
    for seed in range(20):
        want, got = _run_both(steps, pipeline_sample, seed)
        for k in ('img', 'gt_bboxes', 'gt_labels', 'gt_masks'):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (seed, k)
        for k in ('filename', 'ori_filename', 'ori_shape', 'img_shape',
                  'pad_shape', 'scale_factor', 'flip', 'flip_direction'):
            assert np.array_equal(np.asarray(got['img_metas'][k]),
                                  np.asarray(want['img_metas'][k])), (seed, k)
        flips.add(bool(want['img_metas']['flip']))
        sizes.add(want['img'].shape[:2])
        dropped += len(want['gt_bboxes']) < 3
    # flip on and off; both branches: the crop branch's sizes are not the
    # plain branch's 480-800 keep-ratio ones, and its crops drop boxes
    assert flips == {True, False} and len(sizes) > 5 and dropped


def test_crop_without_boxes_returns_none_on_both_sides(pipeline_sample):
    """allow_negative_crop=False: a seed whose crop keeps no box gives None
    on both sides, and the others equal samples."""
    steps = [dict(type='LoadImageFromFile'),
             dict(type='LoadAnnotations', with_bbox=True, with_mask=True),
             dict(type='RandomCrop', crop_type='absolute', crop_size=(8, 8)),
             dict(type='Normalize', mean=[0, 0, 0], std=[1, 1, 1]),
             dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_masks'])]
    nones = 0
    for seed in range(12):
        want, got = _run_both(steps, pipeline_sample, seed)
        assert (want is None) == (got is None), seed
        if want is None:
            nones += 1
            continue
        for k in ('img', 'gt_bboxes', 'gt_masks'):
            assert np.array_equal(got[k], want[k]), (seed, k)
    assert 0 < nones < 12


# ------------------------------------------------------- sampler, canvas
def test_group_batch_sampler_equals_jax():
    rs = np.random.RandomState(0)
    flags = (rs.rand(23) < 0.4).astype(np.uint8)
    for shuffle in (True, False):
        port = GroupBatchSampler(flags, 2, seed=7, shuffle=shuffle)
        ref = JaxSampler(flags, 2, seed=7, shuffle=shuffle)
        assert len(port) == len(ref)
        for epoch in range(3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(port) == list(ref)


def test_derive_canvas_equals_jax_on_every_config():
    from swindet_tpu_torch.utils import Config
    paths = [os.path.join(d, f) for d in ('configs/swin',
                                          'configs/_base_/datasets')
             for f in sorted(os.listdir(os.path.join(REPO, d)))]
    seen = set()
    for path in paths:
        cfg = Config.fromfile(os.path.join(REPO, path))
        pipeline = _plain([dict(p) for p in cfg.data.train.get(
            'pipeline', cfg.data.train.get('dataset', {}).get('pipeline',
                                                             []))])
        got = derive_canvas(pipeline)
        assert got == jax_derive_canvas(pipeline), path
        seen.add(got)
    assert (1344, 800) in seen and len(paths) == 17


def test_collate_equals_jax_with_square_fallback():
    """Pipeline outputs of both orientations on a landscape canvas: the
    portrait one does not fit, so the batch goes on the square canvas; and
    the landscape ones alone, with more gts than the 100 slots."""
    rs = np.random.RandomState(0)
    samples = []
    for h, w, g in ((64, 96, 3), (96, 64, 0), (60, 90, 120)):
        samples.append(dict(
            img=rs.randn(h, w, 3).astype(np.float32),
            gt_bboxes=rs.rand(g, 4).astype(np.float32) * 50,
            gt_labels=rs.randint(0, 80, g),
            gt_masks=(rs.rand(g, h, w) < 0.3).astype(np.uint8),
            img_metas=dict(img_shape=(h - 3, w - 5, 3))))
    for group, canvas in ((samples, (64, 96)), (samples[2:], (64, 96))):
        got = collate_detection(group, canvas=canvas)
        want = jax_collate(group, canvas=canvas)
        assert got.keys() == want.keys()
        for k in got:
            if k != 'img_metas':
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), k
    assert collate_detection(samples, canvas=(64, 96))['img'].shape[1:3] \
        == (96, 96)


# ------------------------------------------------------------ bias table
@pytest.mark.parametrize('src,dst', [(7, 12), (12, 7)])
def test_bias_table_resize_matches_cv2_cubic(src, dst):
    """F.interpolate's bicubic against cv2's INTER_CUBIC: within 1e-5 of
    the largest entry (float rounding), borders included."""
    rs = np.random.RandomState(src)
    table = rs.randn((2 * src - 1) ** 2, 3).astype(np.float32)
    want = _interp_bias_table(table, (2 * dst - 1) ** 2, 3)
    got = interp_bias_table(torch.from_numpy(table),
                            (2 * dst - 1) ** 2).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize('wrapper', ['RepeatDataset', 'ConcatDataset',
                                     'ClassBalancedDataset'])
def test_dataset_wrappers_equal_jax(tmp_path, wrapper):
    """build_dataset's wrappers over the dummy COCO: length, group flags
    and, for ClassBalancedDataset, the repeats equal the JAX package's;
    each wrapped index gives its dataset's sample for the same
    generator."""
    from swindet_tpu.datasets import build_dataset as jax_build_dataset
    from swindet_tpu_torch.datasets import build_dataset, sample_rng
    inner = dict(type='CocoDataset', ann_file=_dummy_coco(tmp_path),
                 img_prefix=str(tmp_path), classes=('person', 'bicycle'),
                 pipeline=[dict(type='LoadAnnotations', with_bbox=True),
                           dict(type='Collect', keys=['gt_bboxes'])])
    cfg = {'RepeatDataset': dict(type='RepeatDataset', times=3,
                                 dataset=inner),
           'ConcatDataset': dict(type='ConcatDataset',
                                 datasets=[inner, inner]),
           'ClassBalancedDataset': dict(type='ClassBalancedDataset',
                                        oversample_thr=4.0,
                                        dataset=inner)}[wrapper]
    port, ref = build_dataset(copy.deepcopy(cfg)), jax_build_dataset(
        copy.deepcopy(cfg))
    assert len(port) == len(ref) > 3
    assert np.array_equal(port.flag, ref.flag)
    if wrapper == 'ClassBalancedDataset':
        assert port.repeat_indices == ref.repeat_indices
    base = build_dataset(copy.deepcopy(inner))
    for i in range(len(port)):
        j = port.repeat_indices[i] if wrapper == 'ClassBalancedDataset' \
            else i % len(base)
        got = port.get(i, sample_rng(0, 0, i))
        assert np.array_equal(got['gt_bboxes'],
                              base.get(j, sample_rng(0, 0, i))['gt_bboxes'])
