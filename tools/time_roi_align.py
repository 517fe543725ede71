"""Device time of the RoIAlign kernels (``csrc/roi_align.cu``: the forward,
row 4, and the backward, row 9) at the main path's shapes, on one CUDA
card.

    python tools/time_roi_align.py [--by-level] [REPO_ROOT ...]

Each REPO_ROOT (default: this checkout) names a checkout whose
``swindet_tpu_torch`` is timed, each in a process of its own, so two
versions (a parent and a change, in turns) compare on one card in one
call:

    python tools/time_roi_align.py build/parent . . build/parent

The shapes, bf16, C 256, FPN levels of an 800x1344 canvas (strides 4-32):
the forward at serving's bbox (1,000 rois 7x7, batch 1) and mask (100
rois 14x14, batch 1) and at training's bbox (1,024 rois 7x7, batch 2)
and mask (256 rois 14x14, batch 2) shapes, the backward at training's;
then both at 7x7 and 14x14 on 256 rois piled on one 20x20-cell area of
P2, batch 2 (a trained model's mask rois are positives piled on a few
boxes, so the backward's tiles there each sum many rois). The rois,
their work and the bound are chip_smoke.py's (``_rois``,
``_crowded_rois``, ``_roi_work``, ``bound``), taken from the chip_smoke.py
beside this tool whatever the REPO_ROOT; features, output gradients and
rois seeded. Prints one JSON line per checkout:
the card's name and power limit as nvidia-smi reports them and, per
shape, ``ms``, the mean ms of 20 wrapper calls after 3 warm-ups by CUDA
events around them; ``device_ms``, the device time per call of every
kernel the call launches, from torch.profiler over 20 more calls, split
into ``kernel`` (the RoIAlign kernel; for the backward its first
kernel), ``split`` (the backward's split kernel, which sums the tiles
that keep many rois), ``zero_fill`` and ``cast`` (a wrapper's fills and
dtype copies) and ``routing`` (the rest: the level routing's torch
kernels), with ``launches``, the RoIAlign kernels the profiler saw per
call (fewer than the call launches: it lost events, read that row
again); and ``bound_ms``, the larger of the bytes the
call must move (each input read once, each output written once; the
forward reads only the feature cells its samples touch) over 3.35 TB/s
and its operations over 989 TFLOP/s. With ``--by-level``, also
``by_level``: the kernels' device time with no roi valid (what the
launch, the backward's scan and its level writes cost alone) and with
the rois of one FPN level valid at a time (the rest masked off by
``roi_valid``).
"""
import importlib.util
import json
import os
import subprocess
import sys

# (kernel, rois, out_size, batch, name)
SHAPES = (('fwd', 1000, 7, 1, 'serving bbox'),
          ('fwd', 100, 14, 1, 'serving mask'),
          ('fwd', 1024, 7, 2, 'training bbox'),
          ('fwd', 256, 14, 2, 'training mask'),
          ('bwd', 1024, 7, 2, 'training bbox'),
          ('bwd', 256, 14, 2, 'training mask'),
          ('fwd', 256, 7, 2, 'crowded'),
          ('fwd', 256, 14, 2, 'crowded'),
          ('bwd', 256, 7, 2, 'crowded'),
          ('bwd', 256, 14, 2, 'crowded'))
STRIDES = (4, 8, 16, 32)
C = 256
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, its imports of swindet_tpu_torch
    resolved in the checkout that is timed."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time(fn, iters=20):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20):
    """Device ms per call by part: the RoIAlign kernel, fills, dtype
    copies and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = dict(kernel=0.0, split=0.0, zero_fill=0.0, cast=0.0,
                 routing=0.0, launches=0.0)
    for e in prof.key_averages():
        key = e.key.lower()
        part = ('split' if 'roi_align_bwd_split' in key else
                'kernel' if 'roi_align' in key else
                'zero_fill' if 'fill' in key else
                'cast' if 'copy' in key else 'routing')
        parts[part] += e.device_time_total / 1e3 / iters
        if part in ('kernel', 'split'):
            parts['launches'] += e.count / iters
    return parts


def run(root: str, by_level: bool) -> None:
    sys.path.insert(0, root)
    import torch
    from swindet_tpu_torch.ops import roi_align, roi_align_bwd
    from swindet_tpu_torch.ops.roi_align import map_roi_levels
    if not torch.cuda.is_available():
        raise SystemExit('time_roi_align: needs a CUDA device')
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    dtype, el = torch.bfloat16, 2
    out = {}
    for kind, n, size, batch, name in SHAPES:
        feats = [torch.randn(batch, h, w, C, generator=gen).cuda().to(dtype)
                 for h, w in cs.FPN_SHAPES]
        rois = (cs._crowded_rois(gen, n) if name == 'crowded' else
                cs._rois(gen, n, batch=batch))
        touched, samples = cs._roi_work(cs.FPN_SHAPES, rois, STRIDES, size)
        flops = samples * C * 4 * 2.0
        if kind == 'bwd':
            shapes = [tuple(f.shape) for f in feats]
            g = torch.randn(n, size, size, C, generator=gen).cuda().to(dtype)

        def fn(valid=None):
            if kind == 'fwd':
                return roi_align(feats, rois, STRIDES, size, roi_valid=valid)
            return roi_align_bwd(shapes, dtype, rois, g, STRIDES, size,
                                 roi_valid=valid)
        if kind == 'fwd':
            nbytes = (touched * C * el + rois.numel() * 4
                      + n * size ** 2 * C * el)
        else:
            nbytes = (g.numel() * el + rois.numel() * 4
                      + sum(f.numel() for f in feats) * el)
        bound = cs.bound(nbytes, flops)[0]
        row = dict(ms=_time(fn), device_ms=_device_ms(fn), bound_ms=bound)
        if by_level:
            lvl = map_roi_levels(rois, len(cs.FPN_SHAPES))
            masks = {'none': lvl < 0}
            masks.update({f'level {i}': lvl == i
                          for i in range(len(cs.FPN_SHAPES))})
            row['by_level'] = {}
            for k, m in masks.items():
                d = _device_ms(lambda: fn(m))
                row['by_level'][k] = d['kernel'] + d['split']
        out[f'{kind} {name}: {n} rois {size}x{size}, batch {batch}'] = row
        del feats
        torch.cuda.empty_cache()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({'root': root, 'card': smi, 'roi_align': out}),
          flush=True)


def main() -> None:
    args = sys.argv[1:]
    flags = [a for a in args if a == '--by-level']
    roots = [os.path.abspath(r) for r in args if r not in flags] or [HERE]
    if len(roots) == 1:
        run(roots[0], bool(flags))
        return
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), *flags,
                        root], check=True, timeout=900)


if __name__ == '__main__':
    main()
