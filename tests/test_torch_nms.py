"""The port's NMS over score-sorted boxes (``ops/nms.py:nms_sorted``; on a
CPU tensor its plain version) against the JAX package's Pallas NMS kernel
``nms_pallas_sorted`` run with ``interpret=True``, as
tests/test_ops/test_nms_pallas.py runs it: the same cases and more, on the
same numpy inputs. Nothing is left to a tolerance: count, indices and
detections must be equal, since RPN proposals feed the sampler and one
flipped box changes the losses."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.ops.nms_pallas import nms_pallas_sorted

from swindet_tpu_torch.ops import nms_sorted, nms_sorted_reference


def _random_boxes(rs, n, offset=False):
    """The boxes of tests/test_ops/test_nms_pallas.py; with ``offset``,
    shifted by a class offset as batched_nms does (coordinates near 1e4
    to 1e5, where IoUs are coarse)."""
    xy = rs.rand(n, 2).astype(np.float32) * 300
    wh = rs.rand(n, 2).astype(np.float32) * 80 + 4
    boxes = np.concatenate([xy, xy + wh], -1)
    if offset:
        cls = rs.randint(0, 80, n).astype(np.float32)
        boxes = boxes + (cls * np.float32(385.0))[:, None]
    return boxes


def _sorted(boxes, scores, valid):
    score = np.where(valid, scores, -np.inf).astype(np.float32)
    order = np.argsort(-score, kind='stable')
    return boxes[order], score[order], valid[order], order


def _padded(bs, ss, vs, order):
    """The Pallas kernel takes N in whole 128-box tiles: pad with invalid
    boxes, which score -inf and so sort last."""
    n = len(ss)
    pad = -n % 128
    return (np.concatenate([bs, np.zeros((pad, 4), np.float32)]),
            np.concatenate([ss, np.full(pad, -np.inf, np.float32)]),
            np.concatenate([vs, np.zeros(pad, bool)]),
            np.concatenate([order, np.arange(n, n + pad)]))


def _check(boxes, scores, valid, iou_thr, max_out):
    """nms_sorted on a batch of images against the Pallas kernel run on
    each image; returns the counts."""
    srt = [_sorted(*a) for a in zip(boxes, scores, valid)]
    args = [torch.from_numpy(np.stack([s[i] for s in srt]))
            for i in range(4)]
    dets, inds, count = nms_sorted(*args, iou_thr, max_out)
    assert dets.dtype == torch.float32 and inds.dtype == torch.int64
    assert tuple(dets.shape) == (len(srt), max_out, 5)
    for b, one in enumerate(srt):
        bs, ss, vs, order = _padded(*one)
        w_dets, w_inds, w_cnt = nms_pallas_sorted(
            jnp.asarray(bs), jnp.asarray(ss), jnp.asarray(vs),
            jnp.asarray(order.astype(np.int32)), iou_thr, max_out,
            interpret=True)
        assert int(count[b]) == int(w_cnt)
        np.testing.assert_array_equal(inds[b].numpy(), np.asarray(w_inds))
        np.testing.assert_array_equal(dets[b].numpy(), np.asarray(w_dets))
    want = nms_sorted_reference(*args, iou_thr, max_out)
    for a, w in zip((dets, inds, count), want):
        assert torch.equal(a, w)
    return count.tolist()


@pytest.mark.parametrize('seed,n,iou_thr', [(0, 256, 0.5), (3, 1024, 0.5),
                                            (7, 512, 0.7), (11, 128, 0.3)])
def test_nms_sorted_matches_pallas(seed, n, iou_thr):
    rs = np.random.RandomState(seed)
    boxes = _random_boxes(rs, n)
    scores = rs.rand(n).astype(np.float32)
    valid = rs.rand(n) > 0.1
    _check(boxes[None], scores[None], valid[None], iou_thr, 100)


def test_nms_sorted_dense_overlaps(seed=5):
    """Heavy suppression chains (many near-duplicates)."""
    rs = np.random.RandomState(seed)
    base = np.array([[10, 10, 60, 60]], np.float32)
    boxes = np.repeat(base, 256, 0) + rs.randn(256, 4).astype(np.float32) * 3
    scores = rs.rand(256).astype(np.float32)
    count = _check(boxes[None], scores[None], np.ones((1, 256), bool), 0.5,
                   64)
    assert 1 < count[0] < 64


def test_nms_sorted_batch_of_two_with_class_offsets():
    """B = 2, the images' boxes and validity apart, at the coordinates of
    batched_nms's class offsets."""
    rs = np.random.RandomState(13)
    boxes = np.stack([_random_boxes(rs, 384, offset=True) for _ in range(2)])
    scores = rs.rand(2, 384).astype(np.float32)
    valid = rs.rand(2, 384) > np.array([[0.1], [0.6]])
    count = _check(boxes, scores, valid, 0.7, 300)
    assert count[0] != count[1]


def test_nms_sorted_stops_at_max_out():
    rs = np.random.RandomState(17)
    boxes = _random_boxes(rs, 512)
    scores = rs.rand(512).astype(np.float32)
    valid = np.ones(512, bool)
    full = _check(boxes[None], scores[None], valid[None], 0.5, 512)
    assert full[0] > 20
    assert _check(boxes[None], scores[None], valid[None], 0.5, 20) == [20]


# The kernel's scan resolves 64 sorted boxes a step and carries the
# suppressions of a step's kept boxes into the blocks after it: cases at
# the 64-box block edges.
def _chain(n, lead=1):
    """Boxes 10 px wide, each 3 px right of the one before (IoU 0.538 with
    the next, 0.25 with the one after it), from index ``lead`` on, after
    ``lead`` boxes far away; scores falling with the index. At IoU 0.5
    every other box of the chain is kept: with lead 1 boxes 63 and 127
    are kept and suppress 64 and 128, across a block edge."""
    x = np.arange(n, dtype=np.float32) * 3
    x[:lead] = 5000 + 100 * np.arange(lead)
    boxes = np.stack([x, np.zeros(n, np.float32), x + 10,
                      np.full(n, 10, np.float32)], -1)
    return boxes, np.linspace(1, 0.1, n).astype(np.float32)


@pytest.mark.parametrize('n,lead', [(300, 1), (200, 0)])
def test_nms_sorted_chain_across_blocks(n, lead):
    boxes, scores = _chain(n, lead)
    count = _check(boxes[None], scores[None], np.ones((1, n), bool), 0.5,
                   200)
    assert count == [lead + (n - lead + 1) // 2]


@pytest.mark.parametrize('k', [1, 2])
def test_nms_sorted_max_out_mid_block(k):
    """Disjoint boxes, all kept: max_out stops the scan at index 64 k + 5,
    inside a block."""
    n = 320
    x = np.arange(n, dtype=np.float32) * 20
    boxes = np.stack([x, x * 0, x + 10, x * 0 + 10], -1)
    scores = np.linspace(1, 0.1, n).astype(np.float32)
    count = _check(boxes[None], scores[None], np.ones((1, n), bool), 0.5,
                   64 * k + 6)
    assert count == [64 * k + 6]


@pytest.mark.parametrize('n', [127, 128, 129, 191, 192, 193])
def test_nms_sorted_block_edges(n):
    """N one short of, at and one past a whole number of 64-box blocks."""
    rs = np.random.RandomState(n)
    _check(_random_boxes(rs, n)[None], rs.rand(1, n).astype(np.float32),
           rs.rand(1, n) > 0.1, 0.3, 100)


def test_nms_sorted_every_box_invalid():
    rs = np.random.RandomState(23)
    boxes = np.stack([_random_boxes(rs, 130) for _ in range(2)])
    count = _check(boxes, rs.rand(2, 130).astype(np.float32),
                   np.zeros((2, 130), bool), 0.5, 50)
    assert count == [0, 0]
