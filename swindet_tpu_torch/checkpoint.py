"""Weights in and out of the port.

:func:`state_dict_from_jax` is the inverse of the JAX package's
``convert_torch_state_dict`` (``swindet_tpu/checkpoint.py:365``): it turns
a JAX parameter tree (nested dicts of numpy arrays) into the port's
mmdet-keyed ``state_dict``. :func:`load_checkpoint` loads an mmdet ``.pth``
into a port model as it is; :func:`load_weights` loads starting weights
(``model.pretrained``, ``load_from``) as the JAX package's converter
does, leaving what the file lacks. :func:`save_checkpoint` and
:func:`resume` keep the train state in mmdet's format: ``state_dict``
(mmdet keys), ``optimizer`` and ``meta`` (epoch, iter).
"""
from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# flax submodule name -> mmdet prefix (swindet_tpu/checkpoint.py:33); other
# submodules drop their leading underscore, a cascade's indexed heads
# ('_bbox_head0') included
_NAME_MAP = {
    '_backbone': 'backbone', '_neck': 'neck', '_rpn_head': 'rpn_head',
    '_roi_head': 'roi_head', '_bbox_head': 'bbox_head',
    '_mask_head': 'mask_head', '_bbox_extractor': 'bbox_roi_extractor',
    '_mask_extractor': 'mask_roi_extractor', '_teacher': 'teacher_model',
}
# a deformable RoI pool pack's layers, flat in the JAX package
# (roi_layers{l}_{offset|mask}_{fc1|fc2|out}), mmcv's Sequential indices
_DPOOL = re.compile(r'^roi_layers(\d+)_(offset|mask)_(fc1|fc2|out)$')
_DPOOL_INDEX = {'offset': {'fc1': 0, 'fc2': 2, 'out': 4},
                'mask': {'fc1': 0, 'out': 2}}
# a ResNet block's norms, which mmdet names gn{i} for a GN
_RESNET_NORM = re.compile(r'^bn(\d)$')
_INDEXED = re.compile(r'^(layers|blocks|lateral_convs|fpn_convs|bns|'
                      r'shared_convs|shared_fcs|convs|cls_convs|reg_convs|'
                      r'reppoints_cls_convs|reppoints_pts_convs|head_convs|'
                      r'bbox_head|mask_head|neck)(\d+)$')
# a ConvModule's anonymous flax norm -> mmcv's name for it
_NORMS = {('norm', 'BatchNorm_0'): 'bn', ('norm', 'GroupNorm_0'): 'gn',
          ('norm', 'LayerNorm_0'): 'ln'}
# parameters, and the batch statistics of a BN
_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
         'mean': 'running_mean', 'var': 'running_var'}
# buffers a released checkpoint may carry that the port rebuilds itself
_IGNORED = ('relative_position_index', 'attn_mask')
# the top-level parts of a detector: a checkpoint whose keys start with none
# of them is a backbone's own (a classification pretrain)
_DETECTOR_PARTS = ('backbone.', 'neck.', 'rpn_head.', 'roi_head.',
                   'bbox_head.', 'mask_head.', 'query_embedding.')


def flax_path_to_torch_key(path: Tuple[str, ...],
                           resnet_gn: bool = False) -> str:
    """('_backbone', 'layers0', 'blocks1', 'attn', 'qkv', 'kernel') ->
    'backbone.layers.0.blocks.1.attn.qkv.weight';
    ('_roi_head', '_bbox_head0', 'shared_convs0', 'norm', 'BatchNorm_0',
    'mean') -> 'roi_head.bbox_head.0.shared_convs.0.bn.running_mean'."""
    parts: List[str] = []
    names = list(path[:-1])
    while names:
        if tuple(names[:2]) in _NORMS:
            parts.append(_NORMS[tuple(names[:2])])
            names = names[2:]
            continue
        p = names.pop(0)
        p = _NAME_MAP.get(p, p[1:] if p.startswith('_') else p)
        m, dpool = _INDEXED.match(p), _DPOOL.match(p)
        if m:
            p = f'{m.group(1)}.{m.group(2)}'
        elif dpool:
            lvl, branch, layer = dpool.groups()
            p = f'roi_layers.{lvl}.{branch}_fc.{_DPOOL_INDEX[branch][layer]}'
        elif resnet_gn and _RESNET_NORM.match(p):
            p = 'g' + p[1:]
        parts.append(p)
    parts.append(_LEAF.get(path[-1], path[-1]))
    return '.'.join(parts)


# the JAX package's module names that differ from mmdet's, renamed on the
# tree (see state_dict_from_jax)
_PLUGIN = re.compile(r'^plugin\d+$')
_RES2NET_STEM = re.compile(r'^stem(_bn)?(\d)$')
_HR_BRANCH = re.compile(r'^branches(\d+)\.(\d+)$')
_HR_FUSE = re.compile(r'^fuse(\d+)\.(\d+)\.(?:down(\d+)\.)?(conv|bn)$')
_HR_TRANSITION = re.compile(r'^transition(\d+)\.(\d+)\.(conv|bn)$')
_BARE_NECK_CONV = re.compile(r'^(reduction_conv|fpn_convs\d+)$')
_SEQ_INDEX = {'conv': 0, 'bn': 1}
# NASFCOS_FPN's flax names (dotted), and a ConcatCell's output norm and
# conv: mmdet's ConvModules adapt_convs.{i}, extra_downsamples.{i} and
# out_conv (its norm 'bn', its conv 'conv')
_NAS_ADAPT = re.compile(r'^adapt_convs(\d+)\.(conv|bn)$')
_NAS_EXTRA = re.compile(r'^extra_downsamples(\d+)$')
_NAS_CELL = {'out_norm': 'out_conv.bn', 'out_conv': 'out_conv.conv'}


def _mmdet_name(name: str, tree: dict, parent: dict) -> str:
    """mmdet's name of the JAX module ``name`` (holding ``tree``, a child
    of ``parent``)."""
    if _PLUGIN.match(name):
        return 'gen_attention_block' if 'value_conv' in tree \
            else 'context_block'
    m = _RES2NET_STEM.match(name)
    if m and 'stem_bn0' in parent:
        return f'stem.{3 * int(m.group(2)) + bool(m.group(1))}'
    m = _HR_BRANCH.match(name)
    if m:
        return f'branches.{m.group(1)}.{m.group(2)}'
    m = _HR_FUSE.match(name)
    if m:
        i, j, k, kind = m.groups()
        seq = f'.{k}' if k is not None else ''
        return f'fuse_layers.{i}.{j}{seq}.{_SEQ_INDEX[kind]}'
    m = _HR_TRANSITION.match(name)
    if m:
        n, i, kind = m.groups()
        new = '.0' if int(i) >= int(n) else ''
        return f'transition{n}.{i}{new}.{_SEQ_INDEX[kind]}'
    m = _NAS_ADAPT.match(name)
    if m:
        return f'adapt_convs.{m.group(1)}.{m.group(2)}'
    m = _NAS_EXTRA.match(name)
    if m:
        return f'extra_downsamples.{m.group(1)}.conv'
    if name in _NAS_CELL and 'out_norm' in parent:
        return _NAS_CELL[name]
    return name


def _mmdet_tree(tree: dict) -> dict:
    """A JAX tree (params, batch statistics or gradients) with mmdet's
    module names and shapes where the JAX package's differ."""
    out = {}
    avg_down = 'bns0' in tree or 'norm0' in tree.get('conv2', {})
    for name, v in tree.items():
        if not isinstance(v, dict):
            out[name] = v
            continue
        v = _mmdet_tree(v)
        if _BARE_NECK_CONV.match(name) and 'kernel' in v:
            v = {'conv': v}
        if 'norm0' in v and name == 'conv2':
            v = {{'norm0': 'bn0', 'norm1': 'bn1'}.get(k, k): t
                 for k, t in v.items()}
        if _PLUGIN.match(name):
            v = _mmdet_plugin(v)
        if avg_down and name.startswith('downsample.'):
            name = f'downsample.{int(name.split(".")[1]) + 1}'
        out[_mmdet_name(name, v, tree)] = v
    return out


def _mmdet_plugin(tree: dict) -> dict:
    """A plugin's leaves in mmcv's shapes: ContextBlock's LayerNorm
    (planes,) -> (planes, 1, 1); GeneralizedAttention's ``appr_bias`` and
    ``geom_bias`` (heads, qk_dim) -> (heads * qk_dim,)."""
    out = dict(tree)
    for k, v in tree.items():
        if k in ('appr_bias', 'geom_bias'):
            out[k] = np.reshape(v, (-1,))
        elif k.endswith('_conv.1'):
            out[k] = {n: np.reshape(a, (-1, 1, 1)) for n, a in v.items()}
    return out


def _flatten(tree, prefix=()):
    out = {}
    if 'conv_offset' in tree and isinstance(tree.get('conv'), dict) \
            and 'weight' in tree['conv']:
        # a ModulatedDeformConvPack: mmcv keeps its conv's weight and bias
        # beside conv_offset, the JAX pack in a child 'conv'
        tree = dict(tree)
        tree.update(tree.pop('conv'))
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_dict_from_jax(params: Dict, batch_stats: Optional[Dict] = None,
                        roi_feat_size: int = 7,
                        resnet_gn: bool = False) -> Dict[str, torch.Tensor]:
    """mmdet-keyed ``state_dict`` of a JAX parameter tree and, for models
    with BN, its ``batch_stats`` collection:

    - conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
    - the mask head's deconv (kh, kw, in, out) -> (in, out, kh, kw),
      spatially un-flipped;
    - a deformable conv's tap-major ``weight`` (K, in, out) -> mmcv's
      (out, in, kh, kw), kh = kw = sqrt(K) (the inverse of
      ``swindet_tpu/checkpoint.py:496-500``);
    - the first FC of a bbox head (a cascade's too), which reads the
      (s, s, C) roi features flattened HWC in JAX, reads them CHW as in
      mmdet (s = ``roi_feat_size``);
    - norm ``scale`` -> ``weight``; a BN's ``mean`` / ``var`` ->
      ``running_mean`` / ``running_var``, with ``num_batches_tracked`` 0;
    - a deformable pack's ``conv`` child (weight, bias) -> mmcv's names
      beside ``conv_offset``; a deformable RoI pool's per-level FCs
      ``roi_layers{l}_offset_fc1`` ... -> ``roi_layers.{l}.offset_fc.0``
      ... (the inverse of ``swindet_tpu/checkpoint.py:295``);
    - with ``resnet_gn`` (a ResNet with ``norm_cfg`` GN), the blocks' and
      the stem's ``bn{i}`` -> ``gn{i}``: a GN's parameters are a BN's, so
      the tree does not tell them apart;
    - a ResNet plugin ``plugin{i}`` -> ``gen_attention_block`` (the one
      with a ``value_conv``) or ``context_block`` (mmcv's abbreviations;
      a config's ``postfix`` is not in the tree, and no config sets one);
      ContextBlock's LayerNorm ``channel_add_conv.1`` (and
      ``channel_mul_conv.1``) (planes,) -> mmcv's (planes, 1, 1);
      GeneralizedAttention's ``appr_bias`` / ``geom_bias`` (heads,
      qk_dim) -> (heads * qk_dim,);
    - Res2Net's deep stem ``stem{i}`` / ``stem_bn{i}`` -> ``stem.{3i}`` /
      ``stem.{3i + 1}`` (mmdet's Sequential of conv, norm, ReLU) and its
      ``bns{i}`` -> ``bns.{i}``;
    - a Res2Net or ResNeSt block's ``downsample.0`` / ``.1`` ->
      ``downsample.1`` / ``.2``: mmdet's avg-down shortcut holds its
      average pool at index 0 in every stage (ResLayer / Res2Layer with
      avg_down), a block known by its ``bns0`` or by a ``conv2`` holding
      ``norm0``; the ResNeSt split-attention conv's ``norm0`` / ``norm1``
      -> ``bn0`` / ``bn1`` (mmcv's ``build_norm_layer`` with postfix 0 and
      1);
    - HRNet's ``branches{b}.{k}`` -> ``branches.{b}.{k}``;
      ``fuse{i}.{j}.conv`` / ``.bn`` -> ``fuse_layers.{i}.{j}.0`` / ``.1``
      and ``fuse{i}.{j}.down{k}.conv`` / ``.bn`` ->
      ``fuse_layers.{i}.{j}.{k}.0`` / ``.1`` (mmdet's Sequentials);
      ``transition{n}.{i}.conv`` / ``.bn`` -> ``transition{n}.{i}.0`` /
      ``.1`` for a branch stage n has (i < n, its width changed) and
      ``transition{n}.{i}.0.0`` / ``.0.1`` for the new branch (i >= n: a
      Sequential of one strided conv, norm and ReLU; HRNet's stage n has
      n branches in every config);
    - HRFPN's bare ``reduction_conv`` and ``fpn_convs{i}`` -> mmdet's
      ConvModule names ``reduction_conv.conv`` and ``fpn_convs.{i}.conv``;
    - a list of necks ``_neck{i}`` -> ``neck.{i}``;
    - a dense head's per-level ``scales`` vector (L,) (and VFNet's
      ``scales_refine``) -> mmcv's ``Scale`` modules ``scales.{i}.scale``,
      each of shape () (the inverse of ``swindet_tpu/checkpoint.py:405-414``);
    - a distilling detector's ``_teacher`` (params and batch statistics)
      -> mmdet's ``teacher_model.`` before the teacher's own names;
    - a GFL head gains mmdet's ``integral.project`` buffer, the bins
      0..reg_max, which the JAX converter skips (:560);
    - NASFCOS_FPN's ``adapt_convs{i}.conv`` / ``.bn`` ->
      ``adapt_convs.{i}.conv`` / ``.bn``, ``extra_downsamples{i}`` ->
      ``extra_downsamples.{i}.conv``, and a ConcatCell's ``out_norm`` /
      ``out_conv`` -> ``out_conv.bn`` / ``out_conv.conv``.
    """
    params = _mmdet_tree(params)
    batch_stats = _mmdet_tree(batch_stats or {})
    sd = {}
    for path, leaf in _flatten(batch_stats).items():
        key = flax_path_to_torch_key(path, resnet_gn)
        sd[key] = torch.from_numpy(np.array(leaf, np.float32))
        if path[-1] == 'mean':
            sd[key.rsplit('.', 1)[0] + '.num_batches_tracked'] = \
                torch.tensor(0, dtype=torch.long)
    for path, leaf in _flatten(params).items():
        a = np.asarray(leaf)
        if path[-1] in ('scales', 'scales_refine') and a.ndim == 1:
            prefix = flax_path_to_torch_key(path, resnet_gn)
            for i, v in enumerate(np.array(a, np.float32)):
                sd[f'{prefix}.{i}.scale'] = torch.tensor(v)
            continue
        if path[-1] == 'kernel' and a.ndim == 4:
            if 'upsample' in path:
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                a = a.transpose(3, 2, 0, 1)
        elif path[-1] == 'weight' and a.ndim == 3:
            k = int(round(np.sqrt(a.shape[0])))
            a = a.reshape(k, k, *a.shape[1:]).transpose(3, 2, 0, 1)
        elif path[-1] == 'kernel' and a.ndim == 2:
            a = a.T
            if path[-2] == 'shared_fcs0' and any(
                    p.startswith('_bbox_head') for p in path):
                s = roi_feat_size
                out_dim, in_dim = a.shape
                a = a.reshape(out_dim, s, s, in_dim // (s * s)) \
                    .transpose(0, 3, 1, 2).reshape(out_dim, in_dim)
        sd[flax_path_to_torch_key(path, resnet_gn)] = torch.from_numpy(
            np.ascontiguousarray(a))
        if path[-2:] == ('gfl_reg', 'bias'):
            # mmdet's Integral buffer of the bins 0..reg_max, which the JAX
            # package rebuilds at trace time
            n = a.shape[0] // 4
            sd[flax_path_to_torch_key(path[:-2] + ('integral', 'project'),
                                      resnet_gn)] = torch.linspace(0, n - 1,
                                                                   n)
    return sd


def _weights(ckpt) -> Dict[str, torch.Tensor]:
    """A loaded ``.pth``'s weights: under 'state_dict' or 'model', or the
    whole file, without a 'module.' prefix and without the buffers the
    port rebuilds."""
    sd = ckpt
    if isinstance(ckpt, dict):
        sd = ckpt.get('state_dict', ckpt.get('model', ckpt))
    return {k[len('module.'):] if k.startswith('module.') else k: v
            for k, v in sd.items() if not any(b in k for b in _IGNORED)}


def _read(filename: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(weights, meta) of a ``.pth``."""
    ckpt = torch.load(filename, map_location='cpu', weights_only=True)
    return _weights(ckpt), (ckpt.get('meta', {})
                            if isinstance(ckpt, dict) else {})


def load_checkpoint(model: torch.nn.Module, filename: str) -> dict:
    """Load an mmdet ``.pth`` (``state_dict`` under 'state_dict' or
    'model', or bare) into ``model``, strictly but for the buffers the
    port rebuilds. Returns the checkpoint's meta dict."""
    sd, meta = _read(filename)
    model.load_state_dict(sd, strict=True)
    return meta


def interp_bias_table(table: torch.Tensor, target_len: int) -> torch.Tensor:
    """A ((2w - 1)^2, heads) relative-position bias table resized to
    ``target_len`` rows, bicubic over its square (the port of
    ``_interp_bias_table``, ``swindet_tpu/checkpoint.py:85``, whose
    cv2 INTER_CUBIC has the same A = -0.75 kernel, half-pixel centres and
    replicated border as ``F.interpolate``'s bicubic)."""
    s1, s2 = int(round(table.shape[0] ** 0.5)), int(round(target_len ** 0.5))
    nh = table.shape[1]
    t = table.float().reshape(s1, s1, nh).permute(2, 0, 1)[None]
    t = F.interpolate(t, size=(s2, s2), mode='bicubic', align_corners=False)
    return t[0].permute(1, 2, 0).reshape(s2 * s2, nh)


def load_weights(model: torch.nn.Module, filename: str,
                 logger: Optional[logging.Logger] = None) -> dict:
    """Starting weights from a ``.pth``, as the JAX package's converter
    loads ``model.pretrained`` and ``load_from``
    (``swindet_tpu/checkpoint.py:365``): a file whose keys name no
    detector part is a backbone's own, and its keys get the 'backbone.'
    prefix (MoBY's 'encoder.' dropped); a bias table of another window
    size is resized (:func:`interp_bias_table`); every other tensor must
    match its parameter's shape. Parameters the file lacks keep their
    values. Logs what was missing and unexpected; returns the meta."""
    logger = logger or logging.getLogger('swindet')
    sd, meta = _read(filename)
    sd = {k[len('encoder.'):] if k.startswith('encoder.') else k: v
          for k, v in sd.items()}
    if hasattr(model, 'backbone') and not any(
            k.startswith(_DETECTOR_PARTS) for k in sd):
        sd = {f'backbone.{k}': v for k, v in sd.items()}
    own = model.state_dict()
    load = {}
    for k, v in sd.items():
        if k not in own:
            continue
        if k.endswith('relative_position_bias_table') \
                and v.shape[0] != own[k].shape[0]:
            v = interp_bias_table(v, own[k].shape[0])
        if v.shape != own[k].shape:
            raise ValueError(f'{filename}: {k} has shape {tuple(v.shape)}, '
                             f'the model {tuple(own[k].shape)}')
        load[k] = v
    missing, _ = model.load_state_dict(load, strict=False)
    unexpected = sorted(set(sd) - set(load))
    logger.info(f'load {filename}: {len(load)} tensors, {len(missing)} '
                f'missing, {len(unexpected)} unexpected')
    if missing:
        logger.warning(f'missing: {missing}')
    if unexpected:
        logger.warning(f'unexpected: {unexpected}')
    return meta


def save_checkpoint(filename: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[dict] = None) -> None:
    """mmcv's checkpoint: ``meta``, the model's ``state_dict`` (on the
    CPU) and the optimizer's, written atomically."""
    ckpt = dict(meta=dict(meta or {}), state_dict={
        k: v.detach().cpu() for k, v in model.state_dict().items()})
    if optimizer is not None:
        ckpt['optimizer'] = optimizer.state_dict()
    tmp = f'{filename}.tmp{os.getpid()}'
    torch.save(ckpt, tmp)
    os.replace(tmp, filename)


def resume(filename: str, model: torch.nn.Module,
           optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """Load a :func:`save_checkpoint` file back: the weights strictly,
    the optimizer's state (moved to its parameters' device). Returns the
    meta (epoch, iter)."""
    ckpt = torch.load(filename, map_location='cpu', weights_only=True)
    model.load_state_dict(_weights(ckpt), strict=True)
    if optimizer is not None:
        if 'optimizer' not in ckpt:
            raise KeyError(f'{filename} holds no optimizer state')
        optimizer.load_state_dict(ckpt['optimizer'])
    return ckpt.get('meta', {})
