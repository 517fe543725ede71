"""Seven configs of the ResNet zoo in the port against the JAX package on
the CPU, fp32, each shrunk as tiny_maskrcnn_cfg shrinks the Swin configs
(a ResNet-50 of base width 8, FPN and heads at 32 channels, the C4 and DC5
heads at the shrunk backbone's widths, GN in groups of 4, 4 classes, small
samplers and proposal counts) with the config's graph otherwise as it is:

- Mask R-CNN R-50 with DCNv2 in stages 2-4 (``mdconv``), Faster R-CNN
  R-50 with DCN (``dconv``), Mask R-CNN R-50 with GN and ConvWS everywhere
  (``gn_ws``), Mask R-CNN R-50 C4 (``c4``: the res5 shared head, the
  average-pool BBoxHead, the conv-free mask head), Faster R-CNN R-50 DC5
  (``dc5``), Faster R-CNN R-50 with modulated deformable RoI pooling
  (``mdpool``) and Cascade R-CNN R-50 (``cascade_r50``);
- ``simple_test`` of each on the same weights (rpn_cls and every fc_cls
  drawn with std 1, so that no top-k or NMS boundary sits within fp32
  noise) and batch statistics: detections (and mask probabilities) equal;
- ``forward_train`` of the four that chip_smoke.py trains on the card
  (mdconv, gn_ws, c4, mdpool) with the same sampler keys: losses and
  every gradient;
- each config's weights through ``state_dict_from_jax`` and back through
  the JAX converter bit for bit (gn_ws after renaming its ResNet's gn{i},
  which the JAX converter cannot read, test_torch_dcn.py);
- each config at full width: the port's parameter and buffer names and
  shapes equal ``state_dict_from_jax`` of the JAX init's shapes.

Tolerances are test_torch_resnet.py's: detections with labels equal,
boxes within 1e-3 px and scores and mask probabilities within 1e-4, losses
at rel 1e-4, gradients at 1e-3 of each tensor's largest entry.
"""
import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.checkpoint import (convert_torch_state_dict,
                                    default_flatten_hints)
from swindet_tpu.core.bbox.samplers import RandomSampler as JaxSampler
from swindet_tpu.engine.train_step import parse_losses as jax_parse_losses
from swindet_tpu.models import build_detector as jax_build_detector

from tests.test_torch_cascade import _draw_stats
from tests.test_torch_checkpoint import numpy_params
from tests.test_torch_dcn import _perturbed
from tests.test_torch_train import make_batch, sampler_keys
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import state_dict_from_jax
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.utils.config import Config

cap_torch_threads()

TOL_LOSS = 1e-4
TOL_GRAD = 1e-3
H, W = 64, 96

ZOO = {
    'mdconv': 'configs/dcn/mask_rcnn_r50_fpn_mdconv_c3-c5_1x_coco.py',
    'dconv': 'configs/dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py',
    'gn_ws': 'configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py',
    'c4': 'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py',
    'dc5': 'configs/faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py',
    'mdpool': 'configs/dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py',
    'cascade_r50': 'configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py',
}
TRAINED = ('mdconv', 'gn_ws', 'c4', 'mdpool')


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def full_cfg(name):
    cfg = _plain(Config.fromfile(ZOO[name]).model)
    cfg.pop('pretrained', None)
    return cfg


def _groups4(part):
    if part and (part.get('norm_cfg') or {}).get('type') == 'GN':
        part['norm_cfg'] = dict(part['norm_cfg'], num_groups=4)


def tiny_zoo_cfg(name, stages=4):
    """The config's model shrunk: widths, classes, samplers and proposal
    counts (and with ``stages`` the ResNet's first stages only); every
    module type and option as configured."""
    cfg = full_cfg(name)
    bb = cfg['backbone']
    bb['base_channels'] = 8
    _groups4(bb)
    neck = cfg.get('neck')
    if stages < 4:
        bb.update(num_stages=stages, out_indices=tuple(range(stages)))
    if neck:
        neck.update(in_channels=[32, 64, 128, 256][:stages],
                    out_channels=32)
        _groups4(neck)
        c = 32
    else:
        c = 32 * 2 ** bb['out_indices'][-1]
    cfg['rpn_head'].update(in_channels=c, feat_channels=c)
    roi = cfg['roi_head']
    ext = roi['bbox_roi_extractor']
    ext['out_channels'] = c
    if ext['roi_layer']['type'] != 'RoIAlign':
        ext['roi_layer'].update(output_channels=c, deform_fc_channels=64)
    head_in = c
    if roi.get('shared_head'):
        roi['shared_head']['base_channels'] = 8
        head_in = 8 * 2 ** roi['shared_head']['stage'] * 4
    heads = roi['bbox_head'] if isinstance(roi['bbox_head'], list) \
        else [roi['bbox_head']]
    for h in heads:
        h.update(in_channels=head_in, fc_out_channels=64,
                 conv_out_channels=32, num_classes=4)
        _groups4(h)
    if roi.get('mask_head'):
        if roi.get('mask_roi_extractor'):
            roi['mask_roi_extractor']['out_channels'] = c
        roi['mask_head'].update(in_channels=head_in, conv_out_channels=32,
                                num_classes=4)
        _groups4(roi['mask_head'])
    train, test = cfg['train_cfg'], cfg['test_cfg']
    train['rpn']['sampler']['num'] = 64
    train['rpn_proposal'].update(nms_pre=128, max_per_img=64)
    stages = train['rcnn'] if isinstance(train['rcnn'], list) \
        else [train['rcnn']]
    for s in stages:
        s['sampler']['num'] = 32
    test['rpn'].update(nms_pre=128, max_per_img=64)
    test['rcnn']['max_per_img'] = 16
    return cfg


def _blocks(params):
    return [v for k, v in params['_backbone'].items()
            if k.startswith('layer')]


def _fc_cls_leaves(params):
    roi = params['_roi_head']
    return [roi[k]['fc_cls'] for k in sorted(roi)
            if k.startswith('_bbox_head')]


@functools.lru_cache(maxsize=None)
def _zoo(name, stages=4):
    """A shrunk config's JAX detector, numpy params (rpn_cls and the
    fc_cls kernels drawn with std 1) and batch statistics, and the port's
    detector on them (eval mode); built once per module, as the serving
    and the training tests share it (none of them changes it)."""
    cfg = tiny_zoo_cfg(name, stages)
    jm = jax_build_detector(copy.deepcopy(cfg))
    params = numpy_params(jm, 0, method='forward_dummy')
    rs = np.random.RandomState(100)
    for leaf in [params['_rpn_head']['rpn_cls']] + _fc_cls_leaves(params):
        leaf['kernel'] = rs.randn(*leaf['kernel'].shape).astype(np.float32)
    for block in _blocks(params):
        # offsets of a tenth of a cell or so, as a trained DCN's are small
        # (both packages start them at zero): at numpy_params' draws, of a
        # cell or more, the DCN detector moves its boxes by 1.9e-3 px
        # under fp32 noise of 1e-7 in its input in the JAX package itself
        # (test_torch_dcn.py holds the ResNet at those draws)
        if 'conv2.conv_offset' in block:
            block['conv2.conv_offset'] = jax.tree.map(
                lambda a: a * np.float32(0.1), block['conv2.conv_offset'])
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    stats = _draw_stats(shapes.get('batch_stats', {}), 200)
    gn = name == 'gn_ws'
    sd = state_dict_from_jax(params, stats, resnet_gn=gn)
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(sd, strict=True)
    return dict(name=name, cfg=cfg, jm=jm, params=params, stats=stats,
                sd=sd, port=port.eval(), gn=gn)


@pytest.fixture(scope='module', params=list(ZOO))
def zoo(request):
    return _zoo(request.param)


def test_zoo_weights_round_trip_bit_exact(zoo):
    """state_dict_from_jax, then the JAX package's convert_torch_state_dict
    gives the parameters and batch statistics back bit for bit."""
    sd = zoo['sd']
    if zoo['gn']:
        sd = {k.replace('.gn', '.bn').replace('backbone.gn1.',
                                              'backbone.bn1.')
              if k.startswith('backbone.') else k: v for k, v in sd.items()}
    new_params, new_stats, report = convert_torch_state_dict(
        sd, zoo['params'], batch_stats=zoo['stats'],
        flatten_hints=default_flatten_hints(zoo['cfg']))
    assert not report['missing'] and not report['unexpected']
    for a, b in ((new_params, zoo['params']), (new_stats, zoo['stats'])):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(np.array_equal(np.asarray(u), v) for u, v in zip(la, lb))


def _det_errors(got, want, v):
    """Box, score and mask probability max |d| over the valid detections
    ``v``."""
    errs = dict(box=np.abs(got['dets'][v][:, :4] - want['dets'][v][:, :4]),
                score=np.abs(got['dets'][v][:, 4] - want['dets'][v][:, 4]))
    if 'mask_probs' in want:
        errs['mask'] = np.abs(got['mask_probs'][v] - want['mask_probs'][v])
    return {k: float(e.max()) for k, e in errs.items()}


def _test_inputs():
    rs = np.random.RandomState(11)
    img = rs.randn(2, H, W, 3).astype(np.float32)
    shapes = np.array([[H, W], [H - 8, W - 16]], np.int32)
    sf = np.array([[1.0] * 4, [0.75] * 4], np.float32)
    return img, shapes, sf


def test_zoo_simple_test_matches_jax(zoo):
    """simple_test: detections equal (validity and labels), boxes within
    1e-3 px, scores and mask probabilities within 1e-4, each or within
    twice what the JAX package's own output moves by under fp32 noise of
    1e-7 in the input or in the weights where that is more (the DCN and
    GN + ConvWS detectors' boxes: 1.2e-3 to 3.6e-3 px under input noise;
    their features agree to ~1e-6, and their heads carry that further).
    The modules each config adds are in the port's model."""
    port, name = zoo['port'], zoo['name']
    img, shapes, sf = _test_inputs()
    variables = {'params': zoo['params'], 'batch_stats': zoo['stats']}
    run = jax.jit(lambda v, *a: zoo['jm'].apply(v, *a, method='simple_test'))
    want = jax.tree.map(np.asarray, run(variables, img, shapes, sf))
    v = want['det_valid']
    noise = dict(box=0.0, score=0.0, mask=0.0)
    for seed in (3, 4):
        # fp32 noise of 1e-7 in the input, then in the weights
        moved = jax.tree.map(np.asarray, run(
            _perturbed(variables, seed) if seed == 4 else variables,
            _perturbed(img, seed) if seed == 3 else img, shapes, sf))
        assert np.array_equal(moved['det_valid'], v)
        for k, d in _det_errors(moved, want, v).items():
            noise[k] = max(noise[k], d)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in port.simple_test(
            T(img), T(shapes), T(sf)).items()}
    assert set(got) == set(want)
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    errs = _det_errors(got, want, v)
    for k, tol in (('box', 1e-3), ('score', 1e-4), ('mask', 1e-4)):
        if k not in errs:
            continue
        assert errs[k] <= max(tol, 2 * noise[k]), (k, errs[k], noise[k])
    kinds = {type(m).__name__ for m in port.modules()}
    assert {'mdconv': 'ModulatedDeformConvPack',
            'dconv': 'ModulatedDeformConvPack', 'gn_ws': 'WSConv2d',
            'c4': 'ResLayer', 'dc5': 'ResNet', 'mdpool': 'DeformRoIExtractor',
            'cascade_r50': 'CascadeRoIHead'}[name] in kinds
    if name in ('c4', 'dc5'):
        assert port.neck is None
    if name == 'dc5':
        assert port.backbone.layer4[0].conv2.dilation == (2, 2)


@pytest.fixture(scope='module', params=TRAINED)
def zoo_train(request):
    """forward_train on both sides with the same batch, sampler keys and
    proposals: losses and every gradient (the configs that train). gn_ws
    with the first two of its ResNet's stages: at four, the port's FPN
    features sit within 1.6 times the JAX package's own movement under
    fp32 noise of 1e-7 from its (6.9e-5 of the largest entry at P3), and
    that flips one ReLU unit of the RPN conv (pre-activation 3.7e-6
    against -9.5e-5, of a largest 8), moving fpn_convs.1's and rpn_conv's
    gradients by 0.056 and 0.040; the JAX package takes the same flip
    under noise of 1e-6 but under none of 25 seeds at 1e-7.
    test_torch_dcn.py holds the four stages' outputs and gradients, and
    test_zoo_simple_test_matches_jax the four-stage detector."""
    zoo = _zoo(request.param, 2 if request.param == 'gn_ws' else 4)
    cfg, jm = zoo['cfg'], zoo['jm']
    batch = make_batch()
    if not cfg['roi_head'].get('mask_head'):
        del batch['gt_masks']
    strides = cfg['rpn_head']['anchor_generator']['strides']
    per = len(cfg['rpn_head']['anchor_generator']['scales']) \
        * len(cfg['rpn_head']['anchor_generator']['ratios'])
    n_rpn = per * sum(-(-H // s) * -(-W // s) for s in strides)
    n_rcnn = 3 + cfg['train_cfg']['rpn_proposal']['max_per_img']
    keys = sampler_keys(n_rpn, n_rcnn)
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSampler, '_pos_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][0]))
    mp.setattr(JaxSampler, '_neg_keys',
               lambda self, rng, a, m, n: jnp.asarray(keys[n][1]))
    names = ['img', 'img_shapes', 'pad_shapes', 'gt_bboxes', 'gt_valid',
             'gt_labels'] + (['gt_masks'] if 'gt_masks' in batch else [])
    try:
        args = [jnp.asarray(batch[k]) for k in names]

        def total(p, args):
            losses, state = jm.apply(
                {'params': p, 'batch_stats': zoo['stats']}, *args,
                method='forward_train',
                rngs={'sampling': jax.random.PRNGKey(1)},
                mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda mdl, name:
                    name == 'get_proposals')
            loss, log_vars = jax_parse_losses(losses)
            props = state['intermediates']['_rpn_head']['get_proposals'][0]
            return loss, (log_vars, props)
        value_and_grad = jax.jit(jax.value_and_grad(total, has_aux=True))
        (_, (want, props)), grads = value_and_grad(zoo['params'], args)
        # the JAX package's own gradients under fp32 noise in the weights
        # and in the image at once (as rounding differs at every op)
        moved = [value_and_grad(_perturbed(zoo['params'], 5),
                                [_perturbed(args[0], 6)] + args[1:])[1]]
    finally:
        mp.undo()
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(zoo['sd'], strict=True)
    port.train()
    tb = {k: T(v) for k, v in batch.items()}
    tkeys = {part: [tuple(T(k) for k in keys[n])] * 2
             for part, n in (('rpn', n_rpn), ('rcnn', n_rcnn))}
    # the JAX run's proposals in place of the port's own, which lie within
    # ~1e-4 px of them (as the cascade's train check pins them)
    pinned = tuple(T(np.asarray(a)) for a in props)
    port.rpn_head.get_proposals = lambda *a, **kw: pinned
    losses = port.forward_train(*[tb[k] for k in names],
                                sampler_keys=tkeys)
    sum(v for k, v in losses.items() if 'loss' in k).backward()
    return dict(want={k: float(v) for k, v in want.items() if k != 'loss'},
                got={k: float(v.detach()) for k, v in losses.items()},
                want_grads=state_dict_from_jax(
                    jax.tree.map(np.asarray, grads), resnet_gn=zoo['gn']),
                moved_grads=[state_dict_from_jax(
                    jax.tree.map(np.asarray, m), resnet_gn=zoo['gn'])
                    for m in moved],
                port=port)


def test_zoo_forward_train_matches_jax(zoo_train):
    """Losses at rel 1e-4 and every gradient at 1e-3 of its largest
    entry, or at twice what the JAX package's own gradient moves by under
    fp32 noise of 1e-7 in the weights and the image where that is more
    (behind the GN + ConvWS ResNet: up to ~1e-3 at its two stages);
    none in the frozen stem and layer1."""
    want, got = zoo_train['want'], zoo_train['got']
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(v), k
        assert abs(v - want[k]) <= TOL_LOSS * max(abs(want[k]), 1e-6), \
            (k, v, want[k])
    checked = 0
    for name, p in zoo_train['port'].named_parameters():
        w = zoo_train['want_grads'][name]
        if name.startswith(('backbone.conv1.', 'backbone.bn1.',
                            'backbone.gn1.', 'backbone.layer1.')):
            assert p.grad is None and not w.abs().max(), name
            continue
        assert p.grad is not None, name
        if w.abs().max() > 0:
            limit = max([TOL_GRAD] + [2 * _rel(m[name], w)
                                      for m in zoo_train['moved_grads']])
            assert _rel(p.grad, w) <= limit, (name, _rel(p.grad, w), limit)
            checked += 1
    assert checked > 40


@pytest.mark.parametrize('name', list(ZOO))
def test_zoo_full_width_names_and_shapes(name):
    """At full width, every parameter and buffer of the port's detector
    (built on the meta device) has the name and shape that
    state_dict_from_jax gives the JAX init's shapes, part by part."""
    cfg = full_cfg(name)
    jm = jax_build_detector(copy.deepcopy(cfg))
    shapes = jax.eval_shape(
        lambda k: jm.init({'params': k}, jnp.zeros((1, 64, 64, 3)),
                          method='forward_dummy'), jax.random.PRNGKey(0))
    with torch.device('meta'):
        port = build_detector(copy.deepcopy(cfg))
    own = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    keys = set()
    for part, tree in shapes['params'].items():
        sd = state_dict_from_jax(
            {part: jax.tree.map(
                lambda s: np.broadcast_to(np.float32(0), s.shape), tree)},
            {part: jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                shapes.get('batch_stats', {}).get(part, {}))},
            resnet_gn=name == 'gn_ws')
        for k, v in sd.items():
            assert own.get(k) == tuple(v.shape), (k, own.get(k), v.shape)
        keys |= set(sd)
    assert keys == set(own)
