"""Device time of the v3 window-attention kernels, the inference forward,
the training forward that saves P and the backward (rows 2, 6 and 7), at
the Swin-T shapes of the main path, in bf16, on one CUDA card.

    python tools/time_window_attention.py [REPO_ROOT ...]

Each REPO_ROOT (default: this checkout) names a checkout whose
``swindet_tpu_torch`` is timed, each in a process of its own, so two
versions (a parent and a change, in turns) compare on one card in one
call. The forward runs at the windows of one 800x1344 canvas at stages
1-4 (1,392, 360, 96 and 24 windows of 3, 6, 12 and 24 heads, hd 32) with
the stage's shift mask, the training forward and the backward at twice as
many windows (a training batch of 2), the backward from the plain
version's fp32 softmax; inputs are seeded.
Prints one JSON line per checkout: the card's name and power limit as
nvidia-smi reports them; ``ms``, the mean ms of 20 calls after 3
warm-ups by CUDA events around them (as chip_smoke.py phase 3 times a
kernel: where a call's host work, the Python wrapper and the launch,
takes longer than its kernel, this reads the host); and ``device_ms``,
the kernel's own device time per call from torch.profiler over 20 more
calls (the kernels of the ``swindet`` namespace only, not the wrapper's
zeroing of dBias).

    python tools/time_window_attention.py build/parent . . build/parent

times a parent checkout (unpacked with ``git archive`` into
``build/parent/``) and this one in turns.
"""
import json
import os
import subprocess
import sys

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
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if 'swindet' in e.key) / 1e3 / iters


def run(root: str) -> None:
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

    out, dev = {}, {}
    for b_, c, nh, (hp, wp) in STAGES:
        mask = torch.from_numpy(shifted_window_attn_mask(hp, wp, 7, 3)).cuda()
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
            dev[key] = _device_ms(fn)
        del p
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({'root': root, 'card': smi, 'ms': out,
                      'device_ms': dev}), flush=True)


def main() -> None:
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [here]
    if len(roots) == 1:
        run(roots[0])
        return
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       check=True, timeout=900)


if __name__ == '__main__':
    main()
