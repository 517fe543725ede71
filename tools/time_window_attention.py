"""Device time of the window-attention kernels at the Swin-T shapes of
the main path, in bf16, on one CUDA card: the v3 inference forward, the
training forward that saves P and the backward (rows 2, 6 and 7), the
v4 forward and backward with both projections folded in (rows 12 and 13),
the v1 forward over head-major q, k, v (row 14), and the full-map shifted
attention (row 15).

    python tools/time_window_attention.py [--rows v1|v3|v4|swin|all] [REPO_ROOT ...]

Each REPO_ROOT (default: this checkout) names a checkout whose
``swindet_tpu_torch`` is timed, each in a process of its own, so two
versions (a parent and a change, in turns) compare on one card in one
call. The forward runs at the windows of one 800x1344 canvas at stages
1-4 (1,392, 360, 96 and 24 windows of 3, 6, 12 and 24 heads, hd 32) with
the stage's shift mask, the training forward and the backward at twice as
many windows (a training batch of 2), the backward from the plain
version's fp32 softmax; inputs are seeded. The v4 rows take x, the fp32
weights of the stage's Swin block and the shift mask: the forward at a
request's windows, the backward at a training batch's. The v1 rows take
the packed qkv as the v3 forward does, at a request's windows; their
wrapper makes the head-major copy of q, k and v before the kernel, and
``copy_device_ms`` gives that copy's device time apart (every kernel
outside the ``swindet`` namespace), ``sdpa_ms`` the CUDA-event ms of
``F.scaled_dot_product_attention`` on the same q, k, v and the additive
bias and mask in bf16 (a yardstick; the port never calls it). The swin
rows take the stage's padded qkv map of one image, (1, Hp, Wp, 3C), with
shift 3, and ``swin`` gives two yardsticks beside row 15 on the same map,
each with its CUDA-event ms, device ms (all its kernels) and max |d| from
row 15's output, both taken from this checkout's chip_smoke.py: ``chain``,
the unfused chain ``torch.roll`` -> window partition ->
``F.scaled_dot_product_attention`` with bias + shift mask as one bf16
additive mask -> window reverse, in rolled coordinates as row 15 (the
table's library column; the port never calls it); ``blockwise``, the
port's own path for the same attention, the ``window_gather_indices``
gather of the map's qkv, row 2 (``window_attention_v3``) with the shift
mask and the inverse gather, which un-rolls, beside ``unrolled``, row 15
followed by the ``torch.roll`` that un-rolls its output.
Prints one JSON line per checkout: the card's name and power limit as
nvidia-smi reports them; ``ms``, the mean ms of 20 calls after 3
warm-ups by CUDA events around them (as chip_smoke.py phase 3 times a
kernel: where a call's host work, the Python wrapper and the launch,
takes longer than its kernel, this reads the host); and ``device_ms``,
the kernel's own device time per call from torch.profiler over 20 more
calls (the kernels of the ``swindet`` namespace only, not the wrapper's
zeroing of dBias). ``kernels`` splits each v4 row's device time by kernel
function (the backward's several kernels, the weights' bf16 cast).

    python tools/time_window_attention.py build/parent . . build/parent

times a parent checkout (unpacked with ``git archive`` into
``build/parent/``) and this one in turns.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (windows of one image, C, heads, padded map (Hp, Wp)) at stages 1-4
STAGES = ((1392, 96, 3, (203, 336)), (360, 192, 6, (105, 168)),
          (96, 384, 12, (56, 84)), (24, 768, 24, (28, 42)))


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
    """The swindet kernels' device ms per call, in all and by kernel
    function name, and the other kernels' in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split, other = {}, 0.0
    for e in prof.key_averages():
        ms = e.device_time_total / 1e3 / iters
        if 'swindet' in e.key:
            name = re.search(r'(\w+(?:<[^()]*>)?)\(', e.key)
            key = name.group(1) if name else e.key
            split[key] = split.get(key, 0.0) + ms
        else:
            other += ms
    return sum(split.values()), split, other


def run_v1(randn, torch, mask, b_, c, nh, out, dev, kernels, copy, sdpa):
    """Row 14 at one stage, at a request's windows: the wrapper (the
    head-major copy and the kernel), the kernel's and the copy's device
    ms, and SDPA on the same inputs."""
    import torch.nn.functional as F
    from swindet_tpu_torch.ops import window_attention
    bias = randn(nh, 49, 49, scale=0.5, dtype=torch.float32)
    qkv = randn(b_, 49, 3 * c)
    key = f'window_attention ({b_}, 49, 3x{c}) shifted'
    fn = lambda: window_attention(qkv, bias, mask, nh)  # noqa: E731
    out[key] = _time(fn)
    dev[key], kernels[key], copy[key] = _device_ms(fn)
    q, k, v = qkv.view(b_, 49, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    nw = mask.shape[0]
    add = (bias[None, None] + mask[None, :, None]).expand(
        b_ // nw, -1, -1, -1, -1).reshape(b_, nh, 49, 49).to(qkv.dtype)
    sdpa[key] = _time(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=add))


def run_v4(randn, torch, mask, b_, c, nh, out, dev, kernels):
    """Rows 12 and 13 at one stage: the forward at a request's windows, the
    backward at a training batch's."""
    from swindet_tpu_torch.ops import (window_attention_v4,
                                       window_attention_v4_bwd)
    f32 = torch.float32
    w = (randn(3 * c, c, scale=c ** -0.5, dtype=f32),
         randn(3 * c, scale=0.1, dtype=f32))
    bias = randn(nh, 49, 49, scale=0.5, dtype=f32)
    wproj = randn(c, c, scale=c ** -0.5, dtype=f32)
    bproj = randn(c, scale=0.1, dtype=f32)
    x = randn(b_, 49, c)
    x2, g2 = randn(2 * b_, 49, c), randn(2 * b_, 49, c)
    for key, fn in (
            (f'window_attention_v4 ({b_}, 49, {c}) {nh} heads shifted',
             lambda: window_attention_v4(x, *w, bias, mask, wproj, bproj,
                                         nh)),
            (f'window_attention_v4_bwd ({2 * b_}, 49, {c}) {nh} heads '
             f'shifted',
             lambda: window_attention_v4_bwd(x2, *w, bias, mask, wproj, g2,
                                             nh))):
        out[key] = _time(fn)
        dev[key], kernels[key], _ = _device_ms(fn)


def _chip_smoke():
    """This checkout's chip_smoke.py, its imports of swindet_tpu_torch
    resolved in the checkout that is timed."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_swin(randn, torch, mask, hw, c, nh, out, dev, kernels, swin):
    """Row 15 at one stage on the padded map of one image, shift 3, with
    the unfused chain and the port's blockwise path beside it (both
    chip_smoke.py's)."""
    from swindet_tpu_torch.ops import swin_window_attention
    cs = _chip_smoke()
    (hp, wp), shift = hw, 3
    bias = randn(nh, 49, 49, scale=0.5, dtype=torch.float32)
    qmap = randn(1, hp, wp, 3 * c)
    key = f'swin_window_attention (1, {hp}, {wp}, 3x{c}) shift {shift}'
    fn = lambda: swin_window_attention(qmap, bias, 7, shift, nh)  # noqa
    got = fn()
    out[key] = _time(fn)
    dev[key], kernels[key], _ = _device_ms(fn)
    unrolled = torch.roll(got, (shift, shift), (1, 2))
    row = {}
    for name, f, want in (
            ('unrolled', lambda: torch.roll(fn(), (shift, shift), (1, 2)),
             unrolled),
            ('chain', cs._swin_chain(qmap, bias, mask, nh, shift), got),
            ('blockwise', cs._swin_blockwise(qmap, bias, mask, nh, shift),
             unrolled)):
        row[f'{name}_max_abs'] = (f().float() - want.float()).abs().max() \
            .item()
        row[f'{name}_ms'] = _time(f)
        mine, _, other = _device_ms(f)
        row[f'{name}_device_ms'] = mine + other
    swin[key] = row


def run(root: str, rows: str) -> None:
    sys.path.insert(0, root)
    import torch
    from swindet_tpu_torch.models.backbones.swin import \
        shifted_window_attn_mask
    from swindet_tpu_torch.ops import (window_attention_bwd,
                                       window_attention_fwd_p,
                                       window_attention_fwd_p_reference,
                                       window_attention_v3)
    if not torch.cuda.is_available():
        raise SystemExit('time_window_attention: needs a CUDA device')
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).cuda().to(dtype)

    out, dev, kernels, copy, sdpa, swin = {}, {}, {}, {}, {}, {}
    for b_, c, nh, (hp, wp) in STAGES:
        mask = torch.from_numpy(shifted_window_attn_mask(hp, wp, 7, 3)).cuda()
        if rows in ('v4', 'all'):
            run_v4(randn, torch, mask, b_, c, nh, out, dev, kernels)
        if rows in ('v1', 'all'):
            run_v1(randn, torch, mask, b_, c, nh, out, dev, kernels, copy,
                   sdpa)
        if rows in ('swin', 'all'):
            run_swin(randn, torch, mask, (hp, wp), c, nh, out, dev, kernels,
                     swin)
        if rows in ('v1', 'v4', 'swin'):
            continue
        bias = randn(nh, 49, 49, scale=0.5, dtype=torch.float32)
        qkv = randn(b_, 49, 3 * c)
        qkv2 = randn(2 * b_, 49, 3 * c)
        _, p = window_attention_fwd_p_reference(qkv2, bias, mask, nh)
        g = randn(2 * b_, 49, c)
        for key, fn in (
                (f'window_attention_v3 ({b_}, 49, 3x{c}) shifted',
                 lambda: window_attention_v3(qkv, bias, mask, nh)),
                (f'window_attention_fwd_p ({2 * b_}, 49, 3x{c}) shifted',
                 lambda: window_attention_fwd_p(qkv2, bias, mask, nh)),
                (f'window_attention_bwd ({2 * b_}, 49, 3x{c})',
                 lambda: window_attention_bwd(qkv2, p, g, nh))):
            out[key] = _time(fn)
            dev[key] = _device_ms(fn)[0]
        del p
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({'root': root, 'card': smi, 'ms': out,
                      'device_ms': dev, 'kernels': kernels,
                      'copy_device_ms': copy, 'sdpa_ms': sdpa,
                      'swin': swin}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--rows', choices=('v1', 'v3', 'v4', 'swin', 'all'),
                    default='all')
    ap.add_argument('roots', nargs='*')
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots] or [HERE]
    if len(roots) == 1:
        run(roots[0], args.rows)
        return
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--rows', args.rows, root], check=True, timeout=900)


if __name__ == '__main__':
    main()
