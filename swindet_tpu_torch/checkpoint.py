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
    '_mask_head': 'mask_head',
}
_INDEXED = re.compile(r'^(layers|blocks|lateral_convs|fpn_convs|'
                      r'shared_convs|shared_fcs|convs|cls_convs|reg_convs|'
                      r'reppoints_cls_convs|reppoints_pts_convs|head_convs|'
                      r'bbox_head|mask_head)(\d+)$')
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


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
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
        m = _INDEXED.match(p)
        parts.append(f'{m.group(1)}.{m.group(2)}' if m else p)
    parts.append(_LEAF.get(path[-1], path[-1]))
    return '.'.join(parts)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_dict_from_jax(params: Dict, batch_stats: Optional[Dict] = None,
                        roi_feat_size: int = 7) -> Dict[str, torch.Tensor]:
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
      ``running_mean`` / ``running_var``, with ``num_batches_tracked`` 0.
    """
    sd = {}
    for path, leaf in _flatten(batch_stats or {}).items():
        key = flax_path_to_torch_key(path)
        sd[key] = torch.from_numpy(np.array(leaf, np.float32))
        if path[-1] == 'mean':
            sd[key.rsplit('.', 1)[0] + '.num_batches_tracked'] = \
                torch.tensor(0, dtype=torch.long)
    for path, leaf in _flatten(params).items():
        a = np.asarray(leaf)
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
        sd[flax_path_to_torch_key(path)] = torch.from_numpy(
            np.ascontiguousarray(a))
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
