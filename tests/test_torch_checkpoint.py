"""Weights between the JAX package and the port: the JAX parameter tree
through ``state_dict_from_jax`` and back through the JAX package's own
``convert_torch_state_dict`` is bit-identical, and the port's models load
the converted ``state_dict`` strictly, with mmdet's key names."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swindet_tpu.checkpoint import (_flatten, convert_torch_state_dict,
                                    default_flatten_hints)
from swindet_tpu.models import build_detector as jax_build_detector
from swindet_tpu.models.builder import build_backbone as jax_build_backbone
from tests.test_models.test_forward import tiny_maskrcnn_cfg
from tests.torch_threads import cap_torch_threads

from swindet_tpu_torch.checkpoint import load_checkpoint, state_dict_from_jax
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.builder import build_backbone

cap_torch_threads()

SWIN_T = dict(type='SwinTransformer', embed_dim=96, depths=[2, 2, 6, 2],
              num_heads=[3, 6, 12, 24], window_size=7, drop_path_rate=0.0)


def numpy_params(module, seed, method=None):
    """A parameter tree for a JAX module, drawn with numpy from ``seed``
    (the tree's structure from ``jax.eval_shape`` of its init): kernels
    N(0, 1/fan_in), biases N(0, 0.02^2), norm scales 1 + N(0, 0.1^2),
    bias tables N(0, 0.1^2)."""
    shapes = jax.eval_shape(
        lambda k: module.init({'params': k},
                              jnp.zeros((1, 64, 64, 3), jnp.float32),
                              method=method), jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == 'bias':
            v = 0.02 * rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes['params'])


def jax_detector_params(cfg, seed=0, spread=True):
    """The JAX detector and numpy params for it. With ``spread``, the
    rpn_cls and fc_cls kernels are drawn with std 1, so that no top-k or
    NMS boundary of a parity test falls within fp32 noise (with the JAX
    package's std-0.01 init, RPN scores sit ~1e-3 apart)."""
    model = jax_build_detector(cfg)
    params = numpy_params(model, seed, method='forward_dummy')
    if spread:
        rs = np.random.RandomState(seed + 100)
        for leaf in (params['_rpn_head']['rpn_cls'],
                     params['_roi_head']['_bbox_head']['fc_cls']):
            leaf['kernel'] = rs.randn(*leaf['kernel'].shape) \
                .astype(np.float32)
    return model, params


def jax_backbone_params(cfg, seed=0):
    model = jax_build_backbone(dict(cfg))
    return model, numpy_params(model, seed)


def _assert_round_trip(params, sd, hints):
    back, report = convert_torch_state_dict(sd, params, flatten_hints=hints)
    assert report['missing'] == [] and report['unexpected'] == []
    want, got = _flatten(params), _flatten(back)
    assert want.keys() == got.keys()
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def test_round_trip_tiny_maskrcnn():
    cfg = tiny_maskrcnn_cfg()
    _, params = jax_detector_params(cfg, spread=False)
    sd = state_dict_from_jax(params)
    _assert_round_trip(params, sd, default_flatten_hints(cfg))
    port = build_detector(cfg)
    port.load_state_dict(sd, strict=True)
    assert 'roi_head.bbox_head.shared_fcs.0.weight' in sd
    assert sd['roi_head.mask_head.upsample.weight'].shape == (32, 32, 2, 2)


def test_round_trip_full_width_swin_t():
    _, params = jax_backbone_params(SWIN_T)
    sd = state_dict_from_jax(params)
    back, report = convert_torch_state_dict(
        {f'backbone.{k}': v for k, v in sd.items()}, {'_backbone': params})
    assert report['missing'] == [] and report['unexpected'] == []
    got = _flatten(back['_backbone'])
    for k, a in _flatten(params).items():
        assert np.array_equal(a, np.asarray(got[k])), k
    port = build_backbone(dict(SWIN_T))
    port.load_state_dict(sd, strict=True)
    assert sd['layers.2.blocks.5.attn.qkv.weight'].shape == (1152, 384)
    assert sd['patch_embed.proj.weight'].shape == (96, 3, 4, 4)


def test_bbox_fc_reads_chw():
    """The bbox head's first FC of the port reads CHW-flattened roi
    features: its weight is the JAX (HWC, out) kernel reordered."""
    cfg = tiny_maskrcnn_cfg()
    _, params = jax_detector_params(cfg, spread=False)
    k = params['_roi_head']['_bbox_head']['shared_fcs0']['kernel']
    w = state_dict_from_jax(params)['roi_head.bbox_head.shared_fcs.0.weight']
    feat = np.random.RandomState(0).randn(7, 7, 32).astype(np.float32)
    want = feat.reshape(-1) @ k
    got = w.numpy() @ feat.transpose(2, 0, 1).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_load_checkpoint_pth(tmp_path):
    """A .pth with mmdet keys, a 'module.' prefix and the buffers mmdet
    saves loads strictly into the port."""
    cfg = tiny_maskrcnn_cfg()
    _, params = jax_detector_params(cfg, spread=False)
    sd = state_dict_from_jax(params)
    saved = {f'module.{k}': v for k, v in sd.items()}
    saved['backbone.layers.0.blocks.0.attn.relative_position_index'] = \
        torch.zeros(49, 49, dtype=torch.long)
    path = tmp_path / 'ckpt.pth'
    torch.save({'state_dict': saved, 'meta': {'CLASSES': ('a', 'b')}}, path)
    port = build_detector(cfg)
    meta = load_checkpoint(port, str(path))
    assert meta['CLASSES'] == ('a', 'b')
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_seeded_init_is_reproducible():
    cfg = tiny_maskrcnn_cfg()
    a, b = build_detector(cfg), build_detector(cfg)
    a.init_weights(3)
    b.init_weights(3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    # the JAX package's schemes: normal(0.01) RPN convs, unit LN scales
    assert abs(sd['rpn_head.rpn_conv.weight'].std().item() - 0.01) < 2e-3
    assert torch.equal(sd['backbone.norm0.weight'],
                       torch.ones_like(sd['backbone.norm0.weight']))
