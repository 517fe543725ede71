"""Training targets and losses of the port against the JAX package's on
the same numpy inputs (CPU): box overlaps and deltas, anchor validity, the
max-IoU assignment, the random sampler with the same keys on both sides,
the RPN, bbox-head and mask-head targets, and each loss.

The JAX sampler's keys come from ``RandomSampler._pos_keys`` /
``_neg_keys``, patched here (monkeypatch, no file changes) to return the
arrays the port is given. Its pack noise (samplers.py:151) orders the
slots only, and every loss is a sum or a masked mean over slots, so the
tests compare slot sets, not slot order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.core.anchors import (AnchorGenerator as JaxAnchors,
                                      anchor_inside_flags as jax_inside)
from swindet_tpu.core.bbox.assigners import MaxIoUAssigner as JaxAssigner
from swindet_tpu.core.bbox.coders import bbox2delta as jax_bbox2delta
from swindet_tpu.core.bbox.iou import bbox_overlaps as jax_overlaps
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.losses.losses import (CrossEntropyLoss as JaxCE,
                                              L1Loss as JaxL1,
                                              accuracy as jax_accuracy)
from swindet_tpu.models.roi_heads.mask_heads import FCNMaskHead as JaxMask
from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.core.anchors import (AnchorGenerator,
                                            anchor_inside_flags)
from swindet_tpu_torch.core.bbox import (MaxIoUAssigner, RandomSampler,
                                         bbox2delta, bbox_overlaps)
from swindet_tpu_torch.models.builder import build_head
from swindet_tpu_torch.models.losses import (CrossEntropyLoss, L1Loss,
                                             accuracy)
from swindet_tpu_torch.models.roi_heads.mask_heads import FCNMaskHead

cap_torch_threads()

T = torch.from_numpy
J = jnp.asarray


def _boxes(rs, n, w=96, h=64, min_size=2.0):
    x1 = rs.uniform(-8, w, n)
    y1 = rs.uniform(-8, h, n)
    bw = rs.uniform(min_size, 48, n)
    bh = rs.uniform(min_size, 40, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


def _gts(rs, g=5, n_valid=3):
    gt = _boxes(rs, g, min_size=8.0)
    valid = np.arange(g) < n_valid
    labels = rs.randint(0, 4, g).astype(np.int32)
    return gt, valid, labels


def _keys(n, seed):
    rs = np.random.RandomState(seed)
    return rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32)


@pytest.fixture
def jax_keys(monkeypatch):
    """Make the JAX sampler read the given key arrays."""
    box = {}
    monkeypatch.setattr(JaxSampler, '_pos_keys',
                        lambda self, rng, a, m, n: J(box['keys'][0]))
    monkeypatch.setattr(JaxSampler, '_neg_keys',
                        lambda self, rng, a, m, n: J(box['keys'][1]))
    return box


# ------------------------------------------------------------- geometry
def test_bbox_overlaps_match_jax():
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 40), _boxes(rs, 7)
    a[3] = a[3, [2, 3, 0, 1]]                     # an inverted box
    b[2, 2:] = b[2, :2]                           # an empty box
    np.testing.assert_allclose(bbox_overlaps(T(a), T(b)),
                               jax_overlaps(J(a), J(b)), atol=1e-6)
    # batched leading dims
    np.testing.assert_allclose(
        bbox_overlaps(T(np.stack([a, a[::-1]])), T(np.stack([b, b]))),
        jax_overlaps(J(np.stack([a, a[::-1]])), J(np.stack([b, b]))),
        atol=1e-6)


def test_bbox2delta_matches_jax():
    rs = np.random.RandomState(1)
    p, g = _boxes(rs, 50), _boxes(rs, 50)
    p[0, 2] = p[0, 0]                             # zero-width proposal
    for means, stds in (((0.,) * 4, (1.,) * 4),
                        ((0.,) * 4, (0.1, 0.1, 0.2, 0.2))):
        np.testing.assert_allclose(
            bbox2delta(T(p), T(g), means, stds),
            jax_bbox2delta(J(p), J(g), means, stds), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('allowed_border', [-1, 0, 8])
def test_valid_and_inside_flags_match_jax(allowed_border):
    kw = dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0],
              scales=[8])
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    pad, img = np.array([52, 90], np.int32), np.array([50, 85], np.int32)
    ours, theirs = AnchorGenerator(**kw), JaxAnchors(**kw)
    flat = torch.cat(ours.grid_anchors(sizes))
    np.testing.assert_array_equal(flat, jnp.concatenate(
        theirs.grid_anchors(sizes)))
    valid = torch.cat(ours.valid_flags(sizes, T(pad)))
    want_valid = jnp.concatenate(theirs.valid_flags(sizes, J(pad)))
    np.testing.assert_array_equal(valid, want_valid)
    assert 0 < int(valid.sum()) < valid.numel()
    np.testing.assert_array_equal(
        anchor_inside_flags(flat, valid, T(img), allowed_border),
        jax_inside(J(flat.numpy()), want_valid, J(img), allowed_border))


# ----------------------------------------------------- assign and sample
ASSIGNERS = [dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3),
             dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5),
             dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
                  match_low_quality=False),
             dict(pos_iou_thr=0.6, neg_iou_thr=0.4, min_pos_iou=0.0)]


@pytest.mark.parametrize('cfg', ASSIGNERS)
def test_max_iou_assigner_matches_jax(cfg):
    rs = np.random.RandomState(2)
    boxes = _boxes(rs, 300)
    gt, gt_valid, labels = _gts(rs)
    # candidates that copy a gt, to exercise the low-quality match
    boxes[:3] = gt[:3]
    bvalid = rs.rand(300) > 0.1
    got = MaxIoUAssigner(**cfg).assign(T(boxes), T(gt), T(gt_valid),
                                       T(labels), bbox_valid=T(bvalid))
    want = JaxAssigner(**cfg).assign(J(boxes), J(gt), J(gt_valid),
                                     J(labels), bbox_valid=J(bvalid))
    np.testing.assert_array_equal(got.gt_inds, want.gt_inds)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.max_overlaps, want.max_overlaps,
                               atol=1e-6)
    assert (got.gt_inds.numpy() > 0).sum() >= 3


@pytest.mark.parametrize('num,frac,add_gt,neg_pos_ub', [
    (64, 0.5, False, -1), (32, 0.25, True, -1), (48, 0.25, True, 3)])
def test_random_sampler_matches_jax(jax_keys, num, frac, add_gt,
                                    neg_pos_ub):
    rs = np.random.RandomState(3)
    boxes = _boxes(rs, 200)
    gt, gt_valid, labels = _gts(rs)
    boxes[:3] = gt[:3] + 0.5
    bvalid = rs.rand(200) > 0.1
    n = 200 + (len(gt) if add_gt else 0)
    keys = _keys(n, seed=4)
    jax_keys['keys'] = keys
    cfg = dict(num=num, pos_fraction=frac, neg_pos_ub=neg_pos_ub,
               add_gt_as_proposals=add_gt)
    a_cfg = ASSIGNERS[1]
    t_assign = MaxIoUAssigner(**a_cfg).assign(T(boxes), T(gt), T(gt_valid),
                                              T(labels), T(bvalid))
    got = RandomSampler(**cfg).sample(
        t_assign, T(boxes), T(gt), T(gt_valid), T(labels), T(bvalid),
        keys=tuple(map(T, keys)))
    j_assign = JaxAssigner(**a_cfg).assign(J(boxes), J(gt), J(gt_valid),
                                           J(labels), bbox_valid=J(bvalid))
    want = JaxSampler(**cfg).sample(jax.random.PRNGKey(0), j_assign,
                                    J(boxes), J(gt), J(gt_valid), J(labels),
                                    bbox_valid=J(bvalid))
    assert int(got.num_pos) == int(want.num_pos) > 0
    assert int(got.num_neg) == int(want.num_neg) > 0

    def slots(s, field):
        v = np.asarray(s.valid)
        return sorted(zip(np.asarray(s.inds)[v].tolist(),
                          np.asarray(s.is_pos)[v].tolist(),
                          np.asarray(getattr(s, field))[v].tolist()))

    for field in ('pos_gt_labels', 'pos_gt_inds'):
        assert slots(got, field) == slots(want, field)
    # positives packed first, fillers out of range
    pos = got.is_pos.numpy()
    assert pos[:int(got.num_pos)].all() and not pos[int(got.num_pos):].any()
    assert (got.inds.numpy()[~got.valid.numpy()] >= n).all()
    v = np.asarray(want.valid)
    order_w = np.argsort(np.asarray(want.inds)[v])
    order_g = np.argsort(got.inds.numpy()[got.valid.numpy()])
    np.testing.assert_allclose(
        got.bboxes.numpy()[got.valid.numpy()][order_g],
        np.asarray(want.bboxes)[v][order_w])
    np.testing.assert_allclose(
        got.pos_gt_bboxes.numpy()[got.valid.numpy()][order_g],
        np.asarray(want.pos_gt_bboxes)[v][order_w])


# ------------------------------------------------------- head targets
def _rpn_targets_inputs():
    rs = np.random.RandomState(5)
    gts = np.stack([_gts(rs)[0] for _ in range(2)])
    valid = np.array([[True, True, True, False, False],
                      [True, True, False, False, False]])
    shapes = np.array([[64, 96], [56, 80]], np.int32)
    return gts, valid, shapes


def test_rpn_targets_match_jax(jax_keys):
    cfg = tiny_maskrcnn_cfg()
    sizes = ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))
    n = 3 * sum(h * w for h, w in sizes)
    keys = _keys(n, seed=6)
    jax_keys['keys'] = keys
    gts, valid, shapes = _rpn_targets_inputs()
    rpn = dict(cfg['rpn_head'], train_cfg=cfg['train_cfg']['rpn'],
               test_cfg=cfg['test_cfg']['rpn'])
    want = jax_build_head(dict(rpn)).apply(
        {}, method=lambda m: m.get_targets(
            jax.random.PRNGKey(0), sizes, m.get_anchors(sizes), J(gts),
            J(valid), None, J(shapes), J(shapes)))
    got = build_head(dict(rpn)).get_targets(
        sizes, T(gts), T(valid), T(shapes), T(shapes),
        keys=[tuple(map(T, keys))] * 2)
    names = ('labels', 'label_weights', 'bbox_targets', 'bbox_weights',
             'num_pos', 'num_neg')
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert (got[4].numpy() > 0).all()


def _rcnn_samples(jax_keys, seed=7):
    cfg = tiny_maskrcnn_cfg()
    rcnn = cfg['train_cfg']['rcnn']
    rs = np.random.RandomState(seed)
    gt, gt_valid, labels = _gts(rs)
    props = _boxes(rs, 64)
    props[:4] = gt[:4] + rs.uniform(-2, 2, (4, 4)).astype(np.float32)
    pvalid = np.arange(64) < 60
    keys = _keys(64 + len(gt), seed=8)
    jax_keys['keys'] = keys
    t_a = MaxIoUAssigner(**dict(rcnn['assigner'], type=None) if False
                         else {k: v for k, v in rcnn['assigner'].items()
                               if k != 'type'})
    s_cfg = {k: v for k, v in rcnn['sampler'].items() if k != 'type'}
    t_samp = RandomSampler(**s_cfg).sample(
        t_a.assign(T(props), T(gt), T(gt_valid), T(labels), T(pvalid)),
        T(props), T(gt), T(gt_valid), T(labels), T(pvalid),
        keys=tuple(map(T, keys)))
    j_a = JaxAssigner(**{k: v for k, v in rcnn['assigner'].items()
                         if k != 'type'})
    j_samp = JaxSampler(**s_cfg).sample(
        jax.random.PRNGKey(0),
        j_a.assign(J(props), J(gt), J(gt_valid), J(labels),
                   bbox_valid=J(pvalid)),
        J(props), J(gt), J(gt_valid), J(labels), bbox_valid=J(pvalid))
    return cfg, t_samp, j_samp


def _by_ind(s, arrays):
    """Rows of ``arrays`` on valid slots, ordered by candidate index."""
    v = np.asarray(s.valid)
    order = np.argsort(np.asarray(s.inds)[v])
    return [np.asarray(a)[v][order] for a in arrays]


def test_bbox_head_targets_match_jax(jax_keys):
    cfg, t_samp, j_samp = _rcnn_samples(jax_keys)
    head_cfg = dict(cfg['roi_head']['bbox_head'])
    rcnn = cfg['train_cfg']['rcnn']
    got = build_head(dict(head_cfg)).get_targets(t_samp, rcnn)
    want = jax_build_head(dict(head_cfg)).apply(
        {}, method=lambda m: m.get_targets(j_samp, rcnn))
    for a, b in zip(_by_ind(t_samp, got), _by_ind(j_samp, want)):
        # the JAX box weights are (num, 1), broadcast over the 4 deltas
        np.testing.assert_allclose(a, np.broadcast_to(b, a.shape),
                                   rtol=1e-6, atol=1e-6)
    assert int(t_samp.num_pos) > 0
    # filler slots are background with zero weight on both sides
    for s, tg in ((t_samp, got), (j_samp, want)):
        v = np.asarray(s.valid)
        assert (np.asarray(tg[1])[~v] == 0).all()


def test_mask_targets_match_jax():
    """Gt masks are filled ellipses and the boxes fractional, so no sample
    sits exactly on the 0.5 threshold (ROADMAP section 3)."""
    rs = np.random.RandomState(9)
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    masks = np.zeros((3, h, w), np.float32)
    ext = np.zeros((3, 4), np.float32)
    for j in range(3):
        cx, cy = rs.uniform(20, 76), rs.uniform(16, 48)
        ax, ay = rs.uniform(8, 20), rs.uniform(6, 16)
        masks[j] = (((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) <= 1
        ext[j] = (cx - ax, cy - ay, cx + ax, cy + ay)
    inds = rs.randint(0, 3, 12).astype(np.int32)
    # positive-like boxes: the mask's extent, jittered by a few pixels
    boxes = ext[inds] + rs.uniform(-4, 4, (12, 4)).astype(np.float32)
    got = FCNMaskHead.get_targets(T(masks), T(boxes), T(inds), 28)
    want = JaxMask.get_targets(J(masks), J(boxes), J(inds), 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 1


# ----------------------------------------------------------------- losses
def test_losses_match_jax():
    rs = np.random.RandomState(10)
    logits = (rs.randn(50, 5) * 2).astype(np.float32)
    labels = rs.randint(0, 5, 50).astype(np.int32)
    labels[:3] = -1
    weight = (rs.rand(50) > 0.3).astype(np.float32)
    avg = np.array(weight.sum() + 2, np.float32)
    for kw in (dict(use_sigmoid=False), dict(use_sigmoid=True)):
        for avg_factor in (None, avg):
            got = CrossEntropyLoss(**kw)(
                T(logits), T(labels), weight=T(weight),
                avg_factor=None if avg_factor is None else T(avg_factor))
            want = JaxCE(**kw)(J(logits), J(labels), weight=J(weight),
                               avg_factor=avg_factor)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # RPN form: one sigmoid channel, background label 1
    pred = rs.randn(2, 40, 1).astype(np.float32)
    lab = rs.randint(0, 2, (2, 40)).astype(np.int32)
    lw = (rs.rand(2, 40) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(CrossEntropyLoss(use_sigmoid=True)(T(pred), T(lab),
                                                 weight=T(lw),
                                                 avg_factor=T(avg))),
        float(JaxCE(use_sigmoid=True)(J(pred), J(lab), weight=J(lw),
                                      avg_factor=avg)), rtol=1e-6)
    # mask form: per-roi BCE over pixels, weighted by positives
    mp = rs.randn(6, 28, 28).astype(np.float32)
    mt = (rs.rand(6, 28, 28) > 0.5).astype(np.float32)
    pw = np.array([1, 1, 0, 1, 0, 1], np.float32)
    np.testing.assert_allclose(
        float(CrossEntropyLoss(use_mask=True)(T(mp), T(mt), weight=T(pw),
                                              avg_factor=torch.tensor(pw.sum()))),
        float(JaxCE(use_mask=True)(J(mp), J(mt), weight=J(pw),
                                   avg_factor=pw.sum())), rtol=1e-6)
    pr, tg = rs.randn(30, 4).astype(np.float32), rs.randn(30, 4).astype(
        np.float32)
    bw = (rs.rand(30, 4) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(L1Loss(loss_weight=2.0)(T(pr), T(tg), weight=T(bw),
                                      avg_factor=T(avg))),
        float(JaxL1(loss_weight=2.0)(J(pr), J(tg), weight=J(bw),
                                     avg_factor=avg)), rtol=1e-6)
    np.testing.assert_allclose(
        float(accuracy(T(logits), T(labels), mask=T(weight))),
        float(jax_accuracy(J(logits), J(labels), mask=J(weight))),
        rtol=1e-6)
