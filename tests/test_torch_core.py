"""The port's plain host and tensor code against the JAX package on the
same numpy inputs: NMS keep sets and keep order (exact), top-k tie order,
anchors, box decoding, result formatting, mask pasting and the test
pipeline's resize."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.core import masks as jax_masks
from swindet_tpu.core.anchors import AnchorGenerator as JaxAnchors
from swindet_tpu.core.bbox.coders import delta2bbox as jax_delta2bbox
from swindet_tpu.core.bbox.transforms import bbox2result as jax_bbox2result
from swindet_tpu.core.nms import (batched_nms as jax_batched_nms,
                                  fast_topk as jax_topk,
                                  multiclass_nms as jax_multiclass_nms,
                                  nms as jax_nms)
from swindet_tpu.datasets.pipelines.transforms import rescale_size \
    as jax_rescale_size

from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.core.anchors import AnchorGenerator
from swindet_tpu_torch.core.bbox import bbox2result, delta2bbox
from swindet_tpu_torch.core.masks import paste_masks
from swindet_tpu_torch.core.nms import (batched_nms, fast_topk,
                                        multiclass_nms, nms)
from swindet_tpu_torch.ops.nms import greedy_keep, pairwise_iou
from swindet_tpu_torch.datasets.pipelines import (imresize_bilinear,
                                                  rescale_size)

cap_torch_threads()

T = torch.from_numpy


def _boxes(rs, n, extent=200.0):
    """Clustered boxes, so that suppression chains are long."""
    centres = rs.uniform(20, extent - 20, (max(n // 8, 1), 2))
    c = centres[rs.randint(0, len(centres), n)] + rs.randn(n, 2) * 6
    wh = rs.uniform(8, 60, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


def _assert_same(res, want, b=0):
    assert np.array_equal(res.valid[b].numpy(), np.asarray(want.valid))
    assert np.array_equal(res.inds[b].numpy(), np.asarray(want.inds))
    np.testing.assert_array_equal(res.dets[b].numpy(),
                                  np.asarray(want.dets))


@pytest.mark.parametrize('n,max_out', [(300, 100), (300, 1000), (37, 64)])
def test_nms_matches_jax(n, max_out):
    rs = np.random.RandomState(n + max_out)
    boxes = _boxes(rs, n)
    scores = rs.rand(n).astype(np.float32)
    valid = rs.rand(n) > 0.1
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out,
                   jnp.asarray(valid))
    got = nms(T(boxes)[None], T(scores)[None], 0.5, max_out,
              T(valid)[None])
    assert want.valid.sum() > 5
    _assert_same(got, want)


def test_nms_batch_rows_are_independent():
    rs = np.random.RandomState(5)
    boxes = np.stack([_boxes(rs, 120), _boxes(rs, 120)])
    scores = rs.rand(2, 120).astype(np.float32)
    got = nms(T(boxes), T(scores), 0.6, 50)
    for i in range(2):
        want = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.6,
                       50)
        _assert_same(got, want, i)


def test_batched_nms_matches_jax():
    rs = np.random.RandomState(7)
    n = 400
    boxes = _boxes(rs, n)
    scores = rs.rand(n).astype(np.float32)
    idxs = rs.randint(0, 5, n).astype(np.int32)
    valid = rs.rand(n) > 0.2
    want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(idxs), 0.7, 200, jnp.asarray(valid))
    got = batched_nms(T(boxes)[None], T(scores)[None],
                      T(idxs.astype(np.int64))[None], 0.7, 200,
                      T(valid)[None])
    _assert_same(got, want)


def test_multiclass_nms_matches_jax():
    rs = np.random.RandomState(11)
    n, k = 150, 6
    boxes = np.concatenate([_boxes(rs, n) for _ in range(k)], 1)
    logits = rs.randn(n, k + 1).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    valid = rs.rand(n) > 0.1
    want = jax_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                              0.05, dict(iou_threshold=0.5), 40,
                              valid=jnp.asarray(valid))
    got = multiclass_nms(T(boxes)[None], T(scores.astype(np.float32))[None],
                         0.05, dict(iou_threshold=0.5), 40,
                         valid=T(valid)[None])
    assert want.valid.sum() == 40
    for name in ('labels', 'inds', 'valid'):
        assert np.array_equal(getattr(got, name)[0].numpy(),
                              np.asarray(getattr(want, name))), name
    np.testing.assert_array_equal(got.dets[0].numpy(),
                                  np.asarray(want.dets))


def test_topk_tie_order_matches_jax():
    scores = np.array([0.5, 0.9, 0.5, -np.inf, 0.9, 0.1, -np.inf, 0.5],
                      np.float32)
    wv, wi = jax_topk(jnp.asarray(scores), 7)
    gv, gi = fast_topk(T(scores)[None], 7)
    assert gi[0].tolist() == np.asarray(wi).tolist() == [1, 4, 0, 2, 7, 5,
                                                         3]
    np.testing.assert_array_equal(gv[0].numpy(), np.asarray(wv))


def test_greedy_keep_matches_sequential_scan():
    rs = np.random.RandomState(3)
    boxes = T(_boxes(rs, 200))
    iou = pairwise_iou(boxes, boxes).numpy()
    init = rs.rand(200) > 0.1
    over = (iou > 0.3) & np.triu(np.ones((200, 200), bool), 1)
    keep = np.zeros(200, bool)
    for i in range(200):
        keep[i] = init[i] and not (keep[:i] & over[:i, i]).any()
    got = greedy_keep(T(over)[None], T(init)[None])[0].numpy()
    assert np.array_equal(got, keep)


def test_anchors_match_jax():
    kw = dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0],
              scales=[8])
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    want = JaxAnchors(**kw).grid_anchors(sizes)
    got = AnchorGenerator(**kw).grid_anchors(sizes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_delta2bbox_matches_jax():
    rs = np.random.RandomState(4)
    rois = _boxes(rs, 50)
    deltas = (rs.randn(50, 12) * 0.5).astype(np.float32)
    deltas[0, 2] = 9.0                          # clipped by wh_ratio_clip
    shape = np.array([120, 150], np.int32)
    want = jax_delta2bbox(jnp.asarray(rois), jnp.asarray(deltas),
                          stds=(0.1, 0.1, 0.2, 0.2),
                          max_shape=jnp.asarray(shape))
    got = delta2bbox(T(rois), T(deltas), stds=(0.1, 0.1, 0.2, 0.2),
                     max_shape=T(shape)[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)


def test_bbox2result_and_paste_masks_match_jax():
    rs = np.random.RandomState(6)
    dets = np.concatenate([_boxes(rs, 10, 90), rs.rand(10, 1)], 1) \
        .astype(np.float32)
    labels = rs.randint(0, 4, 10)
    valid = rs.rand(10) > 0.3
    for g, w in zip(bbox2result(dets, labels, 4, valid),
                    jax_bbox2result(dets, labels, 4, valid)):
        np.testing.assert_array_equal(g, w)
    probs = rs.rand(10, 28, 28).astype(np.float32)
    got = paste_masks(probs, dets[:, :4], 100, 120)
    # the JAX package's numpy path (its native branch is not ported)
    want = np.zeros_like(got)
    for i in range(10):
        x1, y1, x2, y2 = dets[i, :4]
        ix1, iy1 = max(int(np.floor(x1)) - 1, 0), max(int(np.floor(y1)) - 1,
                                                      0)
        ix2, iy2 = min(int(np.ceil(x2)) + 1, 120), min(int(np.ceil(y2)) + 1,
                                                       100)
        ys = (np.arange(iy1, iy2) + 0.5 - y1) / (y2 - y1) * 28 - 0.5
        xs = (np.arange(ix1, ix2) + 0.5 - x1) / (x2 - x1) * 28 - 0.5
        want[i, iy1:iy2, ix1:ix2] = jax_masks._bilinear_2d(
            probs[i], ys, xs) >= 0.5
    assert np.array_equal(got, want)


def test_resize_matches_cv2_bilinear():
    cv2 = pytest.importorskip('cv2')
    rs = np.random.RandomState(8)
    img = rs.randint(0, 256, (97, 131, 3)).astype(np.uint8)
    for scale in ((1333, 800), (60, 40)):
        size = rescale_size((131, 97), scale)
        assert size == jax_rescale_size((131, 97), scale)
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        got = imresize_bilinear(img, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        # cv2 interpolates uint8 in fixed point: off by at most one level
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
