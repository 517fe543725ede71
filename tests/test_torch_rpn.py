"""The port's RPN-only and Fast R-CNN detectors, and the single-stage
detector's list of necks, against the JAX package on the CPU, fp32, on the
same numpy weights, batch statistics and inputs:

- a list of necks: the single-stage detector chains them in order, as the
  JAX package does, under mmdet's ``neck.{i}.`` names; the two-stage
  detector refuses one, as the JAX package cannot run it either;
- ``RPN`` with an FPN and without a neck (the C4 config's single
  stride-16 map), each config shrunk to the JAX tests' tiny sizes
  (``tests/test_models/test_fast_groie.py:26``): ``simple_test``
  (proposals, rescaled, as class-0 detections), ``forward_train``'s two
  losses and every gradient with the same sampler keys, the weights' round
  trip through the JAX converter bit for bit;
- ``FastRCNN`` on proposals handed in (static slots, the padding masked):
  ``simple_test``, ``forward_train`` with the same sampler keys (the gts
  added as proposals first), the round trip;
- the RPN through ``single_gpu_test`` on PNG files and
  ``CocoDataset.evaluate(metric='proposal')`` (AR@100/300/1000, useCats
  0): results and metrics against the JAX package's; ``format_results``
  puts every proposal in class 0;
- ``LoadProposals`` against the JAX pipeline step;
- every config of configs/rpn, fast_rcnn, fcos and nas_fcos built with
  the port's ``build_detector`` on the meta device.

Tolerances are test_torch_backbones.py's: detections with labels equal,
boxes within 1e-3 px and scores within 1e-4 (each or within twice the JAX
package's own movement under fp32 noise of 1e-7 where that is more, in
``check_simple_test``); losses at rel 1e-4 and gradients at 1e-3 of each
tensor's largest entry; metrics equal.
"""
import copy
import functools
import glob

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu import native as jax_native
from swindet_tpu.apis import test as jax_test
from swindet_tpu.apis.inference import DetectorHandle
from swindet_tpu.apis.inference import format_results as jax_format_results
from swindet_tpu.core.bbox import samplers as jax_samplers
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.datasets import CocoDataset as JaxCocoDataset
from swindet_tpu.datasets import build_dataset as jax_build_dataset
from swindet_tpu.datasets.pipelines.extra_augs import \
    LoadProposals as JaxLoadProposals
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.utils import Config as JaxConfig

from tests.test_models.test_single_stage import tiny_retinanet_cfg
from tests.test_torch_backbones import (_ClampedTake, _plain,
                                        check_simple_test, jit_o0)
from tests.test_torch_eval import _seeded_coco
from tests.test_torch_fcos import check_round_trip_names
from tests.test_torch_test_api import eval_pipeline
from tests.test_torch_train import make_batch, sampler_keys
from tests.test_torch_cascade import _draw_stats
from tests.test_torch_checkpoint import numpy_params
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.apis import format_results, single_gpu_test
from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.datasets import CocoDataset, build_dataset
from swindet_tpu_torch.datasets.pipelines import LoadProposals
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.utils.config import Config

from chip_smoke import write_synthetic_coco

cap_torch_threads()

TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
H, W = 64, 96


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------- lists of necks
def _two_necks(cfg):
    neck = cfg['neck']
    c = neck['out_channels']
    cfg['neck'] = [neck, dict(type='FPN', in_channels=[c] * 5,
                              out_channels=c, num_outs=5)]
    return cfg


def test_single_stage_chains_a_list_of_necks():
    """A RetinaNet with two FPNs: the second reads the first's five
    levels, as the JAX package chains them (single_stage.py:49-56);
    detections as check_simple_test holds them, the weights under
    ``neck.0.`` and ``neck.1.`` and back through the JAX converter."""
    case = single_stage_case_retina(_two_necks(tiny_retinanet_cfg()))
    keys = set(case['port'].state_dict())
    assert {'neck.0.lateral_convs.0.conv.weight',
            'neck.1.fpn_convs.4.conv.bias'} <= keys
    assert not any(k.startswith('neck.lateral') for k in keys)
    check_simple_test(case)
    check_round_trip_names(case)


def single_stage_case_retina(cfg):
    """single_stage_case for a RetinaNet: retina_cls drawn with std 1."""
    jm = jax_build_detector(copy.deepcopy(cfg))
    params = numpy_params(jm, 0, method='forward_dummy')
    leaf = params['_bbox_head']['retina_cls']
    leaf['kernel'] = np.random.RandomState(100).randn(
        *leaf['kernel'].shape).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    stats = _draw_stats(shapes.get('batch_stats', {}), 200)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jm=jm, params=params, stats=stats, sd=sd,
                port=port.eval())


def test_two_stage_refuses_a_list_of_necks():
    """The JAX TwoStageDetector builds the list (two_stage.py:41-47) but
    calls it whole (:73-75): a TypeError there; the port refuses it when
    built (here Fast R-CNN's, a TwoStageDetector)."""
    cfg = _two_necks(fast_rcnn_cfg())
    jm = jax_build_detector(copy.deepcopy(cfg))
    with pytest.raises(TypeError, match='not callable'):
        jax.eval_shape(lambda k: jm.init(
            {'params': k}, jnp.zeros((1, 64, 64, 3)),
            method='forward_dummy'), jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match='list of necks'):
        build_detector(copy.deepcopy(cfg))


# -------------------------------------------------------------- configs
RPN_CONFIGS = {'fpn': 'configs/rpn/rpn_r50_fpn_1x_coco.py',
               'c4': 'configs/rpn/rpn_r50_caffe_c4_1x_coco.py'}
FAST_RCNN_CONFIG = 'configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py'


def _config(path):
    cfg = _plain(Config.fromfile(path).model)
    cfg.pop('pretrained', None)
    return cfg


def tiny_rpn_cfg(name):
    """The config with the JAX tests' tiny sizes: a ResNet-18 of base
    width 16 (the C4 one cut to its three stages, as configured), the FPN
    and the RPN at 16 channels (the C4 RPN at layer3's 64), a sampler of
    64, 200 candidates a level (the C4 config's 12,000 at full size) and
    100 proposals."""
    cfg = _config(RPN_CONFIGS[name])
    cfg['backbone'].update(depth=18, base_channels=16)
    if cfg.get('neck'):
        cfg['neck'].update(in_channels=[16, 32, 64, 128], out_channels=16)
        c = 16
    else:
        c = 16 * 2 ** cfg['backbone']['out_indices'][-1]
    cfg['rpn_head'].update(in_channels=c, feat_channels=c)
    cfg['train_cfg']['rpn']['sampler']['num'] = 64
    cfg['test_cfg']['rpn'].update(nms_pre=200, max_per_img=100)
    return cfg


def fast_rcnn_cfg():
    """The Fast R-CNN config at tests/test_models/test_fast_groie.py:26's
    sizes: a ResNet-18 of base width 16, the FPN at 16 channels, the bbox
    head's FCs at 32, 4 classes, a sampler of 32, 16 detections."""
    cfg = _config(FAST_RCNN_CONFIG)
    cfg['backbone'].update(depth=18, base_channels=16)
    cfg['neck'].update(in_channels=[16, 32, 64, 128], out_channels=16)
    roi = cfg['roi_head']
    roi['bbox_roi_extractor']['out_channels'] = 16
    roi['bbox_head'].update(in_channels=16, fc_out_channels=32,
                            num_classes=4)
    cfg['train_cfg']['rcnn']['sampler']['num'] = 32
    cfg['test_cfg']['rcnn']['max_per_img'] = 16
    return cfg


def detector_case(cfg, spread):
    """The JAX detector, numpy params (the module at the path ``spread``,
    a class output, its kernel drawn with std 1: no top-k or NMS boundary
    within fp32 noise) and batch statistics, and the port's detector on
    them (eval mode)."""
    jm = jax_build_detector(copy.deepcopy(cfg))
    params = numpy_params(jm, 0, method='forward_dummy')
    leaf = params
    for k in spread:
        leaf = leaf[k]
    leaf['kernel'] = np.random.RandomState(100).randn(
        *leaf['kernel'].shape).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    stats = _draw_stats(shapes.get('batch_stats', {}), 200)
    sd = state_dict_from_jax(params, stats)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jm=jm, params=params, stats=stats, sd=sd,
                port=port.eval())


def _jax_grads(case, args, keys, method='forward_train'):
    """forward_train's log values and gradients on the JAX side, its
    RandomSampler drawing ``keys`` (by candidate count) and its empty
    slots' gathers clamped (_ClampedTake)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][0]))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][1]))
    mp.setattr(jax_samplers, 'jnp', _ClampedTake())
    try:
        def total(p):
            losses = case['jm'].apply(
                {'params': p, 'batch_stats': case['stats']}, *args,
                method=method, rngs={'sampling': jax.random.PRNGKey(1)})
            return jax_parse_losses(losses)
        (_, want), grads = jit_o0(jax.value_and_grad(total, has_aux=True))(
            case['params'])
    finally:
        mp.undo()
    return ({k: float(v) for k, v in want.items() if k != 'loss'},
            state_dict_from_jax(jax.tree.map(np.asarray, grads)))


def _check_train(case, losses, want, want_grads, frozen=True):
    """Losses at rel 1e-4; every gradient at 1e-3 of its largest entry
    (zero where the JAX package's is), none in the frozen stem and
    layer1."""
    got = {k: float(v.detach()) for k, v in losses.items()}
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(v) and v > 0, k
        assert abs(v - want[k]) <= TOL_LOSS * abs(want[k]), (k, v, want[k])
    sum(losses.values()).backward()
    checked = 0
    for name, p in case['port'].named_parameters():
        w = want_grads[name]
        if frozen and name.startswith(('backbone.conv1.', 'backbone.bn1.',
                                       'backbone.layer1.')):
            assert p.grad is None and not w.abs().max(), name
            continue
        assert p.grad is not None, name
        if not w.abs().max():
            assert not p.grad.abs().max(), name
            continue
        assert _rel(p.grad, w) <= TOL_GRAD, (name, _rel(p.grad, w))
        checked += 1
    return checked


# ------------------------------------------------------------------ RPN
@functools.lru_cache(maxsize=None)
def rpn_case(name):
    case = detector_case(tiny_rpn_cfg(name), ('_rpn_head', 'rpn_cls'))
    case['name'] = name
    return case


@pytest.fixture(scope='module', params=list(RPN_CONFIGS))
def rpn(request):
    return rpn_case(request.param)


def test_rpn_simple_test_matches_jax(rpn):
    """The proposals (rescaled) as detections, every label 0; the C4 RPN
    on the backbone's one stride-16 map."""
    check_simple_test(rpn)
    port = rpn['port']
    assert type(port).__name__ == 'RPN'
    if rpn['name'] == 'c4':
        assert port.neck is None and port.rpn_head.num_base_priors == 15
        with torch.no_grad():
            feats = port.extract_feat(torch.zeros(1, H, W, 3))
        assert len(feats) == 1 and feats[0].shape[1:] == (H // 16, W // 16,
                                                          64)


def test_rpn_forward_train_matches_jax(rpn):
    """loss_rpn_cls and loss_rpn_bbox with the same sampler keys, every
    gradient; the head's train_cfg is train_cfg['rpn']."""
    batch = make_batch()
    names = ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
             'gt_labels']
    gen = rpn['cfg']['rpn_head']['anchor_generator']
    per = len(gen['scales']) * len(gen['ratios'])
    n_rpn = per * sum(-(-H // s) * -(-W // s) for s in gen['strides'])
    keys = sampler_keys(n_rpn, 1)
    want, want_grads = _jax_grads(rpn, [jnp.asarray(batch[k])
                                        for k in names], keys)
    port = rpn['port'].train()
    assert port.rpn_head.sampler.num == 64
    losses = port.forward_train(
        *[T(batch[k]) for k in names],
        sampler_keys=dict(rpn=[tuple(T(k) for k in keys[n_rpn])] * 2))
    assert set(losses) == {'loss_rpn_cls', 'loss_rpn_bbox'}
    assert _check_train(rpn, losses, want, want_grads) > 10
    port.eval()


def test_rpn_weights_round_trip_bit_exact(rpn):
    check_round_trip_names(rpn)


# ----------------------------------------------------------- Fast R-CNN
P_SLOTS = 24


def _proposals(batch, seed=3):
    """Static proposal slots: three jittered copies of each gt, then
    random boxes, the last slots invalid (zeros)."""
    rs = np.random.RandomState(seed)
    b = batch['gt_bboxes'].shape[0]
    props = np.zeros((b, P_SLOTS, 4), np.float32)
    valid = np.zeros((b, P_SLOTS), bool)
    for i in range(b):
        n = 0
        for g in np.flatnonzero(batch['gt_valid'][i]):
            for _ in range(3):
                props[i, n] = batch['gt_bboxes'][i, g] + rs.uniform(-3, 3, 4)
                n += 1
        while n < P_SLOTS - 4 - i:
            x, y = rs.uniform(0, W - 24), rs.uniform(0, H - 20)
            props[i, n] = [x, y, x + rs.uniform(8, 24), y + rs.uniform(8, 20)]
            n += 1
        valid[i, :n] = True
    props = np.clip(props, 0, [W - 1, H - 1, W - 1, H - 1])
    return props * valid[..., None], valid


@pytest.fixture(scope='module')
def fast_rcnn():
    return detector_case(fast_rcnn_cfg(),
                         ('_roi_head', '_bbox_head', 'fc_cls'))


def test_fast_rcnn_simple_test_matches_jax(fast_rcnn):
    """Detections on the proposals handed in: labels equal, boxes within
    1e-3 px, scores within 1e-4; the padding slots take no part."""
    port = fast_rcnn['port']
    assert type(port).__name__ == 'FastRCNN' and port.rpn_head is None
    batch = make_batch()
    props, valid = _proposals(batch)
    shapes = batch['img_shapes']
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    variables = {'params': fast_rcnn['params'],
                 'batch_stats': fast_rcnn['stats']}
    want = jax.tree.map(np.asarray, jit_o0(lambda v, *a: fast_rcnn[
        'jm'].apply(v, *a, method='simple_test'))(
        variables, batch['img'], shapes, sf, props, valid))
    with torch.no_grad():
        got = {k: t.numpy() for k, t in port.simple_test(
            T(batch['img']), T(shapes), T(sf), T(props), T(valid)).items()}
    v = want['det_valid']
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    np.testing.assert_allclose(got['dets'][v][:, :4], want['dets'][v][:, :4],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got['dets'][v][:, 4], want['dets'][v][:, 4],
                               rtol=0, atol=1e-4)


def test_fast_rcnn_forward_train_matches_jax(fast_rcnn):
    """loss_cls, loss_bbox and acc on the proposals handed in, the
    sampler's keys the same over its G + P candidates (the gts added as
    proposals first, add_gt_as_proposals), the JAX argument order; every
    gradient."""
    batch = make_batch()
    del batch['gt_masks']
    props, valid = _proposals(batch)
    names = ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
             'gt_labels']
    n_rcnn = batch['gt_bboxes'].shape[1] + P_SLOTS
    keys = sampler_keys(n_rcnn, 1)
    cfg = fast_rcnn['cfg']['train_cfg']['rcnn']['sampler']
    assert cfg['add_gt_as_proposals']
    want, want_grads = _jax_grads(
        fast_rcnn, [jnp.asarray(batch[k]) for k in names]
        + [jnp.asarray(props), jnp.asarray(valid)], keys)
    port = fast_rcnn['port'].train()
    losses = port.forward_train(
        *[T(batch[k]) for k in names], T(props), T(valid),
        sampler_keys=dict(rcnn=[tuple(T(k) for k in keys[n_rcnn])] * 2))
    assert {'loss_cls', 'loss_bbox'} <= set(losses)
    losses = {k: v for k, v in losses.items() if 'loss' in k}
    want = {k: v for k, v in want.items() if 'loss' in k}
    assert _check_train(fast_rcnn, losses, want, want_grads) > 10
    port.eval()


def test_fast_rcnn_weights_round_trip_bit_exact(fast_rcnn):
    check_round_trip_names(fast_rcnn)


# ----------------------------------------------- RPN from files, and AR
CLASSES = ('a', 'b', 'c', 'd')
SIZES = ((60, 90), (72, 100), (90, 60), (100, 72))


def test_rpn_single_gpu_test_and_proposal_ar_match_jax(tmp_path,
                                                       monkeypatch):
    """single_gpu_test of the RPN on 4 PNGs (2 landscape, 2 portrait):
    every proposal in class 0, results as check_simple_test's limits;
    CocoDataset.evaluate(metric='proposal') on the JAX package's result
    list gives its AR@100/300/1000 and size ARs exactly, and on the
    port's own list the same within 1e-3."""
    rpn = rpn_case('fpn')
    monkeypatch.setattr(jax_native, 'available', lambda: False)
    ann, prefix = write_synthetic_coco(str(tmp_path), SIZES, seed=0,
                                       class_names=CLASSES)
    data = dict(type='CocoDataset', ann_file=ann, img_prefix=prefix,
                classes=CLASSES, pipeline=eval_pipeline(), test_mode=True)
    # a zero box regression: the proposals are the anchors the seeded
    # scores rank, some of which cover the painted polygons
    params = copy.deepcopy(rpn['params'])
    reg = params['_rpn_head']['rpn_reg']
    reg['kernel'] = np.zeros_like(reg['kernel'])
    reg['bias'] = np.zeros_like(reg['bias'])
    handle = DetectorHandle(
        JaxConfig(dict(model=rpn['cfg'])), rpn['jm'],
        {'params': params, 'batch_stats': rpn['stats']}, CLASSES=CLASSES)
    want = jax_test.single_gpu_test(handle, jax_build_dataset(data),
                                    batch_size=2)
    port = build_detector(copy.deepcopy(rpn['cfg']))
    port.load_state_dict(state_dict_from_jax(params, rpn['stats']))
    port.eval()
    port.CLASSES = CLASSES
    got = single_gpu_test(port, build_dataset(data), 2)
    n = 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == len(CLASSES)
        assert all(len(g[c]) == len(w[c]) == 0 for c in (1, 2, 3))
        np.testing.assert_allclose(g[0][:, :4], w[0][:, :4], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(g[0][:, 4], w[0][:, 4], rtol=0, atol=1e-4)
        n += len(g[0])
    assert n >= 100
    port_ds = CocoDataset(ann_file=ann, pipeline=[], classes=CLASSES,
                          img_prefix=prefix, test_mode=True)
    jax_ds = JaxCocoDataset(ann_file=ann, pipeline=[], classes=CLASSES,
                            img_prefix=prefix, test_mode=True)
    metrics = port_ds.evaluate(copy.deepcopy(want), metric='proposal')
    assert metrics == jax_ds.evaluate(copy.deepcopy(want), metric='proposal')
    assert list(metrics)[:3] == ['AR@100', 'AR@300', 'AR@1000']
    assert metrics['AR@1000'] > 0
    own = port_ds.evaluate(got, metric='proposal')
    assert all(abs(own[k] - v) <= 1e-3 for k, v in metrics.items())


def test_proposal_results_format_and_evaluate_equal_jax(tmp_path):
    """Padded RPN outputs (labels all 0, invalid slots) through
    format_results into per-class lists, every proposal in class 0, equal
    to the JAX package's; evaluate(metric='proposal') on them equal to
    its metrics, at each proposal count."""
    path = str(tmp_path / 'ann.json')
    images, anns = _seeded_coco(path)
    rs = np.random.RandomState(4)
    b, p = len(images), 300
    dets = np.zeros((b, p, 5), np.float32)
    valid = np.zeros((b, p), bool)
    for i, img in enumerate(images):
        gts = [a['bbox'] for a in anns if a['image_id'] == img['id']]
        n = 0
        for x, y, bw, bh in gts:
            for _ in range(3):
                j = rs.normal(0, 0.1, 4) * [bw, bh, bw, bh]
                dets[i, n, :4] = [x + j[0], y + j[1], x + bw + j[2],
                                  y + bh + j[3]]
                n += 1
        m = int(rs.randint(150, p))
        xy = rs.uniform(0, 140, (m - n, 2))
        dets[i, n:m, :4] = np.concatenate(
            [xy, xy + rs.uniform(4, 100, (m - n, 2))], 1)
        dets[i, :m, 4] = np.sort(rs.rand(m))[::-1]
        valid[i, :m] = True
    outputs = dict(dets=dets, labels=np.zeros((b, p), np.int64),
                   det_valid=valid)
    metas = [dict(ori_shape=(img['height'], img['width']))
             for img in images]
    classes = ('person', 'bicycle', 'car')
    got = format_results(outputs, metas, len(classes))
    want = jax_format_results(outputs, metas, len(classes))
    for g, w, v in zip(got, want, valid):
        assert len(g[0]) == int(v.sum()) and not len(g[1]) + len(g[2])
        assert all(np.array_equal(a, c) for a, c in zip(g, w))
    kw = dict(ann_file=path, pipeline=[], classes=classes,
              img_prefix=str(tmp_path), test_mode=True)
    for nums in ((100, 300, 1000), (10, 50, 100)):
        m = CocoDataset(**kw).evaluate(copy.deepcopy(got), metric='proposal',
                                       proposal_nums=nums)
        assert m == JaxCocoDataset(**kw).evaluate(
            copy.deepcopy(want), metric='proposal', proposal_nums=nums)
        assert 0 < m['AR@1000'] <= 1


# -------------------------------------------------------- LoadProposals
@pytest.mark.parametrize('case', ['n5', 'n4', 'cropped', 'empty',
                                  'fields', 'bad'])
def test_load_proposals_matches_jax(case):
    """(n, 5) and (n, 4) proposals to fp32 (n, 4), cropped to
    num_max_proposals, an empty set to one zero box, 'proposals' appended
    to bbox_fields (made where missing); an (n, 3) array refused by
    both."""
    rs = np.random.RandomState(6)
    props = {'n5': rs.rand(7, 5) * 50, 'n4': rs.rand(7, 4) * 50,
             'cropped': rs.rand(30, 5) * 50, 'empty': np.zeros((0, 5)),
             'fields': rs.rand(3, 4), 'bad': rs.rand(4, 3)}[case]
    num = 10 if case == 'cropped' else None
    results = dict(proposals=props)
    if case == 'fields':
        results['bbox_fields'] = ['gt_bboxes']
    if case == 'bad':
        for step in (LoadProposals(num), JaxLoadProposals(num)):
            with pytest.raises(AssertionError, match='proposals should'):
                step(copy.deepcopy(results))
        return
    got = LoadProposals(num)(copy.deepcopy(results))
    want = JaxLoadProposals(num)(copy.deepcopy(results))
    assert got['proposals'].dtype == want['proposals'].dtype == np.float32
    assert np.array_equal(got['proposals'], want['proposals'])
    assert got['bbox_fields'] == want['bbox_fields']
    assert got['proposals'].shape == {
        'n5': (7, 4), 'n4': (7, 4), 'cropped': (10, 4), 'empty': (1, 4),
        'fields': (3, 4)}[case]


# ------------------------------------------------------ the config sweep
SWEEP = sorted(sum((glob.glob(f'configs/{d}/*.py') for d in (
    'rpn', 'fast_rcnn', 'fcos', 'nas_fcos')), []))


def test_sweep_lists_the_slice_configs():
    assert len(SWEEP) == 11 + 6 + 11 + 4


@pytest.mark.parametrize('path', SWEEP)
def test_config_builds_in_the_port(path):
    """Every config of the slice builds with the port's build_detector on
    the meta device, as in the JAX package (none fails there)."""
    with torch.device('meta'):
        model = build_detector(_config(path))
    assert type(model).__name__ == _config(path)['type']
