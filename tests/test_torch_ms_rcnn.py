"""Mask Scoring R-CNN and GRoIE in the port against the JAX package on the
CPU, fp32, on the same numpy weights, inputs and sampler keys:

- ``MSELoss``; ``roi_rescale`` and ``SingleRoIExtractor(...,
  roi_scale_factor)``, which rescales before the level mapping as the JAX
  package does (a roi that moves to a coarser level shows the departure
  from mmdet, which maps first);
- ``GenericRoIExtractor`` with its shared 5x5 ``pre`` ConvModule and a
  ``GeneralizedAttention`` post module at ``attention_type='0100'``,
  ``kv_stride=2``, on 7x7 and 14x14 grids, summed and concatenated: its
  output and the gradients of every parameter and of each level;
- ``MaskIoUHead``: its forward and gradients, ``area_ratio`` (summed-area
  tables, BitmapMasks.crop's truncation), ``get_targets`` (raw logits
  binarised) and ``loss``;
- tiny Mask Scoring R-CNN and GRoIE Mask R-CNN detectors (the JAX tests'
  Swin Mask R-CNN at 32 channels, their heads and extractors as the
  configs have them): ``simple_test`` (``mask_scores`` included),
  ``forward_train``'s losses and every gradient, the weights' round trip
  through the JAX converter and a strict ``load_checkpoint`` of the
  mmdet-named file;
- the 14 files of configs/ms_rcnn and configs/groie that build in the JAX
  package build in the port, and the Grid GRoIE file is refused naming
  ``GridRCNN``.

Tolerances: module outputs at 1e-5 of their largest entry, module
gradients at 1e-4; losses at rel 1e-4; detections with labels equal, boxes
within 1e-3 px, scores, mask probabilities and mask scores within 1e-4;
detector gradients at 1e-3 of each tensor's largest entry (or twice the
JAX package's own move under 1e-7 noise where that is more,
``check_forward_train``).
"""
import copy
import functools
import glob

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.models.builder import build_head as jax_build_head
from swindet_tpu.models.builder import \
    build_roi_extractor as jax_build_roi_extractor
from swindet_tpu.models.losses.losses import MSELoss as JaxMSELoss
from swindet_tpu.models.roi_heads.mask_scoring_roi_head import \
    MaskIoUHead as JaxMaskIoUHead
from swindet_tpu.models.roi_heads.roi_extractor import \
    SingleRoIExtractor as JaxSingleRoIExtractor
from swindet_tpu.ops.roi_align import map_roi_levels as jax_map_roi_levels

from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.test_torch_atss import jax_setup
from tests import test_torch_backbones
from tests.test_torch_backbones import (INVARIANT, TOL_INVARIANT,
                                        check_forward_train,
                                        check_round_trip, detector_case)
from tests.test_torch_cascade import numpy_params_from
from tests.test_torch_fcos import _config
from tests.test_torch_zoo import _det_errors, _test_inputs
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                          state_dict_from_jax)
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_head, build_roi_extractor
from swindet_tpu_torch.models.losses import MSELoss
from swindet_tpu_torch.models.roi_heads.mask_scoring_roi_head import \
    MaskIoUHead
from swindet_tpu_torch.models.roi_heads.roi_extractor import (
    SingleRoIExtractor, roi_rescale)
from swindet_tpu_torch.ops.roi_align import map_roi_levels

cap_torch_threads()

TOL_MODULE = 1e-5
TOL_MODULE_GRAD = 1e-4
TOL_LOSS = 1e-4
C = 16
LEVELS = [(16, 24), (8, 12), (4, 6), (2, 3)]
STRIDES = [4, 8, 16, 32]


def T(a):
    return torch.from_numpy(np.array(a))


def jit_fast(fn):
    """test_torch_backbones.jit_o0 with LLVM's expensive passes off too:
    the tiny detectors' JAX references compile in about 11 s where they
    took 15 s (a forward_train gradient), which is most of this file's
    time."""
    jitted, compiled = jax.jit(fn), {}

    def run(*args):
        key = (jax.tree.structure(args),
               tuple(np.shape(a) for a in jax.tree.leaves(args)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options={
                'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True})
        return compiled[key](*args)
    return run


@pytest.fixture(autouse=True)
def _fast_references(monkeypatch):
    """The shared detector checks compile their JAX references with
    jit_fast while this file's tests run."""
    monkeypatch.setattr(test_torch_backbones, 'jit_o0', jit_fast)


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rois(rs, n, h=64, w=96):
    xy = rs.uniform(0, [w - 8, h - 8], (n, 2))
    wh = rs.uniform(3, 60, (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
    col = rs.randint(0, 2, (n, 1))
    return np.concatenate([col, boxes], 1).astype(np.float32)


def _feats(rs):
    return [rs.randn(2, h, w, C).astype(np.float32) for h, w in LEVELS]


# ----------------------------------------------------------------- losses
def test_mse_loss_matches_jax():
    rs = np.random.RandomState(0)
    pred, target = rs.randn(2, 37).astype(np.float32), rs.rand(37)
    weight = (rs.rand(37) > 0.3).astype(np.float32)
    for kw in (dict(weight=weight, avg_factor=9.0), dict(weight=weight),
               dict()):
        got = MSELoss(loss_weight=0.5)(T(pred[0]), T(target), **{
            k: T(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
        want = JaxMSELoss(loss_weight=0.5)(
            jnp.asarray(pred[0]), jnp.asarray(target), **{
                k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()})
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# ------------------------------------------------------------- extractors
def test_roi_rescale_and_scaled_extraction_match_jax():
    rs = np.random.RandomState(1)
    rois = _rois(rs, 40)
    want = JaxSingleRoIExtractor.roi_rescale(jnp.asarray(rois), 1.3)
    assert _rel(roi_rescale(T(rois), 1.3), want) <= 1e-7
    cfg = dict(type='SingleRoIExtractor', out_channels=C,
               roi_layer=dict(type='RoIAlign', output_size=7,
                              sampling_ratio=0), featmap_strides=STRIDES)
    feats = _feats(rs)
    jx = JaxSingleRoIExtractor(**{k: v for k, v in cfg.items()
                                  if k != 'type'})
    want = jax.jit(lambda f, r: jx(f, r, roi_scale_factor=1.3))(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois))
    got = build_roi_extractor(dict(cfg))([T(f) for f in feats], T(rois),
                                         roi_scale_factor=1.3)
    assert _rel(got, want) <= TOL_MODULE


def test_rescale_maps_levels_after_the_rescale():
    """Divergence kept from the JAX package: the rois are rescaled before
    the level mapping, so a roi of scale 100 (level 0 of 4 at
    finest_scale 56: floor(log2(100 / 56))) enlarged by 1.3 to 130 pools
    at level 1; mmdet maps the level on the roi as given (level 0) and
    pools the enlarged roi there."""
    rois = np.array([[0, 10, 10, 110, 110]], np.float32)
    before = map_roi_levels(T(rois), 4, 56)
    after = map_roi_levels(roi_rescale(T(rois), 1.3), 4, 56)
    assert int(before[0]) == 0 and int(after[0]) == 1
    assert int(jax_map_roi_levels(JaxSingleRoIExtractor.roi_rescale(
        jnp.asarray(rois), 1.3), 4, 56)[0]) == 1
    ext = SingleRoIExtractor(dict(type='RoIAlign', output_size=7), C,
                             STRIDES)
    feats = [T(f) for f in _feats(np.random.RandomState(2))]
    got = ext(feats, T(rois), roi_scale_factor=1.3)
    on_level = {lvl: ext([feats[lvl]] * 4, roi_rescale(T(rois), 1.3))
                for lvl in (0, 1)}
    assert torch.equal(got, on_level[1])
    assert not torch.allclose(got, on_level[0])


def groie_cfg(size, aggregation='sum', heads=4):
    return dict(type='GenericRoIExtractor', aggregation=aggregation,
                roi_layer=dict(type='RoIAlign', output_size=size,
                               sampling_ratio=2),
                out_channels=C, featmap_strides=STRIDES,
                pre_cfg=dict(type='ConvModule', in_channels=C,
                             out_channels=C, kernel_size=5, padding=2,
                             inplace=False),
                post_cfg=dict(type='GeneralizedAttention', in_channels=C,
                              spatial_range=-1, num_heads=heads,
                              attention_type='0100', kv_stride=2))


@pytest.mark.parametrize('size,aggregation,valid', [
    (7, 'sum', False), (14, 'sum', True), (7, 'concat', False)])
def test_generic_roi_extractor_matches_jax(size, aggregation, valid):
    """Outputs, and the gradients of a random projection of them for every
    parameter (the shared pre conv, the attention's convs, geometry FCs
    and gamma) and every level."""
    rs = np.random.RandomState(3)
    feats, rois = _feats(rs), _rois(rs, 12)
    roi_valid = rs.rand(12) > 0.3 if valid else None
    cfg = groie_cfg(size, aggregation)
    if aggregation == 'concat':
        cfg['post_cfg'].update(in_channels=4 * C)
        cfg['out_channels'] = 4 * C
    jm = jax_build_roi_extractor(dict(cfg))
    jf = [jnp.asarray(f) for f in feats]
    extra = () if roi_valid is None else (jnp.asarray(roi_valid),)
    shapes = jax.eval_shape(lambda k: jm.init(k, jf, jnp.asarray(rois),
                                              *extra),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 4)
    out_shape = jax.eval_shape(lambda: jm.apply(
        {'params': params}, jf, jnp.asarray(rois), *extra)).shape
    g = rs.randn(*out_shape).astype(np.float32)

    def run(p, f):
        out, vjp = jax.vjp(lambda p, f: jm.apply(
            {'params': p}, f, jnp.asarray(rois), *extra), p, f)
        return out, vjp(jnp.asarray(g))
    want, (gp, gf) = jit_fast(run)(params, jf)
    port = build_roi_extractor(dict(cfg))
    sd = state_dict_from_jax({'_roi_head': {'_bbox_extractor': params}})
    pre = 'roi_head.bbox_roi_extractor.'
    port.load_state_dict({k[len(pre):]: v for k, v in sd.items()},
                         strict=True)
    tf = [T(f).requires_grad_(True) for f in feats]
    got = port(tf, T(rois), None if roi_valid is None else T(roi_valid))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL_MODULE
    (got * T(g)).sum().backward()
    for a, b in zip(tf, gf):
        assert _rel(a.grad, b) <= TOL_MODULE_GRAD
    want_grads = state_dict_from_jax({'_roi_head': {
        '_bbox_extractor': jax.tree.map(np.asarray, gp)}})
    scale = max(float(w.abs().max()) for w in want_grads.values())
    names = 0
    for name, p in port.named_parameters():
        w = want_grads[pre + name]
        assert p.grad is not None, name
        if name.endswith(INVARIANT):
            # a softmax's shift invariance: zero in exact arithmetic
            assert max(float(p.grad.abs().max()), float(w.abs().max())) \
                <= TOL_INVARIANT * scale, name
        else:
            assert _rel(p.grad, w) <= TOL_MODULE_GRAD, (name,
                                                        _rel(p.grad, w))
        names += 1
    # the pre conv's weight and bias; the attention's query, value and
    # proj convs (proj with a bias), its two geometry FCs and gamma
    assert names == 2 + 4 + 4 + 1


# ------------------------------------------------------------ MaskIoUHead
IOU_CFG = dict(type='MaskIoUHead', num_convs=4, num_fcs=2, roi_feat_size=14,
               in_channels=C, conv_out_channels=C, fc_out_channels=32,
               num_classes=5)


@pytest.fixture(scope='module')
def iou_head():
    rs = np.random.RandomState(5)
    feat = rs.randn(6, 14, 14, C).astype(np.float32)
    pred = 2 * rs.randn(6, 28, 28).astype(np.float32)
    jm = jax_build_head(dict(IOU_CFG))
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(feat),
                                              jnp.asarray(pred)),
                            jax.random.PRNGKey(0))
    params = numpy_params_from(shapes['params'], 6)
    port = build_head(dict(IOU_CFG))
    sd = state_dict_from_jax({'_roi_head': {'_mask_iou_head': params}})
    pre = 'roi_head.mask_iou_head.'
    assert pre + 'fcs.0.weight' in sd and pre + 'convs.3.weight' in sd
    port.load_state_dict({k[len(pre):]: v for k, v in sd.items()},
                         strict=True)
    return dict(jm=jm, params=params, port=port, feat=feat, pred=pred,
                pre=pre)


def test_mask_iou_head_matches_jax(iou_head):
    jm, params, port = iou_head['jm'], iou_head['params'], iou_head['port']
    feat, pred = iou_head['feat'], iou_head['pred']
    g = np.random.RandomState(7).randn(6, 5).astype(np.float32)

    def run(p, f, m):
        out, vjp = jax.vjp(lambda p, f, m: jm.apply({'params': p}, f, m),
                           p, f, m)
        return out, vjp(jnp.asarray(g))
    want, (gp, gfeat, gpred) = jit_fast(run)(params, jnp.asarray(feat),
                                           jnp.asarray(pred))
    tfeat, tpred = T(feat).requires_grad_(True), T(pred).requires_grad_(True)
    got = port(tfeat, tpred)
    assert got.shape == (6, 5)
    assert _rel(got, want) <= TOL_MODULE
    (got * T(g)).sum().backward()
    assert _rel(tfeat.grad, gfeat) <= TOL_MODULE_GRAD
    assert _rel(tpred.grad, gpred) <= TOL_MODULE_GRAD
    want_grads = state_dict_from_jax({'_roi_head': {
        '_mask_iou_head': jax.tree.map(np.asarray, gp)}})
    for name, p in port.named_parameters():
        assert _rel(p.grad, want_grads[iou_head['pre'] + name]) \
            <= TOL_MODULE_GRAD, name


def test_mask_iou_targets_and_loss_match_jax(iou_head):
    """area_ratio on boxes past the borders, fractional and degenerate
    (one pixel wide after truncation), get_targets on the raw logits and
    the loss with positives whose target is 0 left out."""
    rs = np.random.RandomState(8)
    masks = (rs.rand(3, 20, 30) > 0.6).astype(np.float32)
    masks[2] = 0.0                               # an empty gt
    boxes = np.array([[-3.5, -2.0, 12.7, 9.9], [4.2, 3.9, 4.8, 30.0],
                      [10.0, 5.0, 40.0, 25.0], [0.0, 0.0, 30.0, 20.0],
                      [7.9, 7.9, 7.1, 7.1], [2.0, 2.0, 9.0, 9.0]],
                     np.float32)
    inds = np.array([0, 1, 1, 0, 2, 2], np.int32)
    want = JaxMaskIoUHead.area_ratio(jnp.asarray(masks), jnp.asarray(boxes),
                                     jnp.asarray(inds))
    got = MaskIoUHead.area_ratio(T(masks), T(boxes), T(inds))
    assert np.array_equal(got.numpy(), np.asarray(want))
    targets = (rs.rand(6, 28, 28) > 0.5).astype(np.float32)
    pred = iou_head['pred']
    want_t = iou_head['jm'].get_targets(want, jnp.asarray(pred),
                                        jnp.asarray(targets), 0.5)
    got_t = MaskIoUHead.get_targets(got, T(pred), T(targets), 0.5)
    assert _rel(got_t, want_t) <= TOL_MODULE
    iou_pred = rs.rand(6).astype(np.float32)
    pos = np.array([1, 1, 0, 1, 1, 1], np.float32)
    want_l = iou_head['jm'].apply(
        {'params': iou_head['params']}, jnp.asarray(iou_pred), want_t,
        jnp.asarray(pos), method='loss')['loss_mask_iou']
    got_l = iou_head['port'].loss(T(iou_pred), got_t, T(pos))
    assert abs(float(got_l['loss_mask_iou']) - float(want_l)) \
        <= TOL_LOSS * abs(float(want_l))


# -------------------------------------------------------- tiny detectors
def ms_rcnn_cfg():
    """The JAX tests' Mask Scoring R-CNN (test_forward.py:223) with the
    configs' MaskIoU head: 4 convs, 2 fcs."""
    cfg = tiny_maskrcnn_cfg()
    cfg['type'] = 'MaskScoringRCNN'
    cfg['roi_head']['type'] = 'MaskScoringRoIHead'
    cfg['roi_head']['mask_iou_head'] = dict(
        IOU_CFG, in_channels=32, conv_out_channels=32, num_classes=4)
    cfg['train_cfg']['rcnn']['mask_thr_binary'] = 0.5
    return cfg


def groie_mask_cfg():
    """The JAX tests' Mask R-CNN with configs/groie's extractors (5x5 pre
    conv, GeneralizedAttention '0100' with kv_stride 2) at 32 channels."""
    cfg = tiny_maskrcnn_cfg()
    roi = cfg['roi_head']
    for key, size in (('bbox_roi_extractor', 7), ('mask_roi_extractor', 14)):
        ext = groie_cfg(size)
        ext['out_channels'] = 32
        ext['pre_cfg'].update(in_channels=32, out_channels=32)
        ext['post_cfg'].update(in_channels=32)
        roi[key] = ext
    return cfg


DETECTORS = {'ms_rcnn': ms_rcnn_cfg, 'groie': groie_mask_cfg}


@functools.lru_cache(maxsize=None)
def _case(name):
    return detector_case(DETECTORS[name]())


@pytest.fixture(scope='module', params=list(DETECTORS))
def detector(request):
    return _case(request.param)


def check_simple_test_exact(jm, variables, port):
    """simple_test of the JAX detector (on ``variables``) and of the port's
    (eval mode) on _test_inputs: validity and labels equal, boxes within
    1e-3 px, scores, mask probabilities and mask scores within 1e-4.
    Returns both outputs and the valid slots."""
    img, shapes, sf = _test_inputs()
    run = jit_fast(lambda v, *a: jm.apply(v, *a, method='simple_test'))
    want = jax.tree.map(np.asarray, run(variables, img, shapes, sf))
    with torch.no_grad():
        got = {k: t.numpy() for k, t in port.eval().simple_test(
            T(img), T(shapes), T(sf)).items()}
    v = want['det_valid']
    assert set(got) == set(want)
    assert np.array_equal(got['det_valid'], v) and v.sum() >= 8
    assert np.array_equal(got['labels'][v], want['labels'][v])
    errs = _det_errors(got, want, v)
    if 'mask_scores' in want:
        errs['mask_scores'] = float(np.abs(got['mask_scores'][v]
                                           - want['mask_scores'][v]).max())
    assert errs['box'] <= 1e-3 and max(
        e for k, e in errs.items() if k != 'box') <= 1e-4, errs
    return got, want, v


def test_detector_simple_test_matches_jax(detector):
    """Detections, mask probabilities and, for Mask Scoring R-CNN,
    ``mask_scores`` (score x relu(own-class iou) of the mask branch run
    again on the detections)."""
    got, want, v = check_simple_test_exact(
        detector['jm'], {'params': detector['params']}, detector['port'])
    scoring = detector['cfg']['type'] == 'MaskScoringRCNN'
    assert ('mask_scores' in got) == scoring
    if scoring:
        assert (want['mask_scores'][v] > 0).any()


def test_detector_forward_train_matches_jax(detector):
    """Losses (loss_mask_iou for Mask Scoring R-CNN) and every gradient,
    the same sampler keys and proposals on both sides."""
    port = check_forward_train(detector, frozen=())
    if detector['cfg']['type'] == 'MaskScoringRCNN':
        g = port.roi_head.mask_iou_head.convs[0].weight.grad
        assert g is not None and float(g.abs().max()) > 0


def test_detector_weights_round_trip_and_load_strictly(detector, tmp_path):
    """The JAX converter reads the port's mmdet-named weights back bit for
    bit (GRoIE's pre_module / post_module and the MaskIoU head's convs,
    fcs and fc_mask_iou under mmdet's names, fcs.0 reordered over its
    stride-2 grid), and load_checkpoint loads a checkpoint of them
    strictly."""
    check_round_trip(detector)
    sd = detector['sd']
    if detector['cfg']['type'] == 'MaskScoringRCNN':
        for key in ('convs.3.weight', 'fcs.0.weight', 'fcs.1.bias',
                    'fc_mask_iou.weight'):
            assert f'roi_head.mask_iou_head.{key}' in sd, key
    else:
        for key in ('bbox_roi_extractor.pre_module.conv.weight',
                    'mask_roi_extractor.post_module.query_conv.weight',
                    'mask_roi_extractor.post_module.appr_geom_fc_x.weight',
                    'bbox_roi_extractor.post_module.gamma'):
            assert f'roi_head.{key}' in sd, key
    path = str(tmp_path / 'released.pth')
    save_checkpoint(path, detector['port'])
    fresh = build_detector(copy.deepcopy(detector['cfg']))
    load_checkpoint(fresh, path)
    assert all(torch.equal(v, fresh.state_dict()[k])
               for k, v in detector['port'].state_dict().items())


def test_mask_iou_fc_reads_its_grid_channel_first():
    """fcs.0 of the converted MaskIoU head reads the 7x7 grid of its last
    (stride-2) conv flattened channel-first, as mmdet's does: a one-hot
    at JAX row (y, x, c) lands at column (c, y, x)."""
    jm = jax_build_head(dict(IOU_CFG))
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 14, 14, C)), jnp.zeros((1, 28, 28))),
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                          shapes['params'])
    y, x, c = 2, 5, 3
    params['fcs0']['kernel'][(y * 7 + x) * C + c, 4] = 1.0
    sd = state_dict_from_jax({'_roi_head': {'_mask_iou_head': params}})
    w = sd['roi_head.mask_iou_head.fcs.0.weight']
    assert float(w[4, c * 49 + y * 7 + x]) == 1.0 and float(w.sum()) == 1.0


# ---------------------------------------------------------------- configs
SWEEP = sorted(glob.glob('configs/ms_rcnn/*.py') + [
    p for p in glob.glob('configs/groie/*.py') if 'grid_rcnn' not in p])
GRID_GROIE = 'configs/groie/grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py'


def test_sweep_lists_the_slice_configs():
    assert len(SWEEP) == 9 + 4


@pytest.mark.parametrize('path', SWEEP)
def test_config_builds_where_jax_builds(path):
    cfg = _config(path)
    jax_setup(copy.deepcopy(cfg))
    with torch.device('meta'):
        model = build_detector(cfg)
    assert type(model).__name__ == cfg['type']
    if 'ms_rcnn' in path:
        assert type(model.roi_head).__name__ == 'MaskScoringRoIHead'
    else:
        assert type(model.roi_head.bbox_roi_extractor).__name__ \
            == 'GenericRoIExtractor'


def test_grid_groie_refused_in_both():
    """The JAX package's GridRoIHead passes its grid extractor a ``dtype``
    that GenericRoIExtractor does not take (TypeError); the port has no
    Grid R-CNN yet and refuses it by name."""
    cfg = _config(GRID_GROIE)
    with pytest.raises(TypeError, match='dtype'):
        jax_setup(copy.deepcopy(cfg))
    with pytest.raises(KeyError, match='GridRCNN'):
        with torch.device('meta'):
            build_detector(cfg)
