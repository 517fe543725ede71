"""How far the plain fused-MLP backward moves when only the summation
order of its fp32 sums changes, in a bf16 run, and how far the kernels
move from it on the card.

    python tools/fused_mlp_bwd_order_spread.py [ROWS C]
    python tools/fused_mlp_bwd_order_spread.py --card [SEEDS]

``fused_mlp_bwd_reference`` rounds the activation and dh to bf16 from
fp32 sums; ``fused_mlp_bwd_reference_f64`` sums fc1 and g @ W2 in float64
and rounds once instead. The first form prints, on the CPU, for dW1, db1
and dW2, max |d| over the largest entry: the spread that another
summation order shows against the plain version, from which
``fused_mlp_bwd_limits`` derives the limits of the kernels' checks.
Default shape: Swin-T stage 3 (8,400 rows, C 384, H 1,536).

``--card`` runs the bf16 backward kernels on a CUDA card at the Swin-T
shapes and at small ones (rows not a multiple of the 64-row tile), each
with SEEDS (default 5) seeded draws, and prints per output the kernel's
max |kernel - plain| over the plain version's spread (the factor that
ORDER_SPREAD_FACTOR must cover) and over its limit
(``fused_mlp_bwd_limits``, which must stay at or below 1). Inputs are
seeded and scaled as the checks' (x, g ~ N(0, 1); W1, W2 ~ N(0, 1 /
fan-in); b1 ~ N(0, 0.01)).
"""
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from swindet_tpu_torch.ops.fused_mlp import (  # noqa: E402
    fused_mlp_bwd, fused_mlp_bwd_limits, fused_mlp_bwd_reference,
    fused_mlp_bwd_reference_f64)

CARD_SHAPES = ((134400, 96), (33600, 192), (8400, 384), (130, 384),
               (2111, 384), (1037, 96), (333, 192))


def inputs(rows, c, seed, device='cpu'):
    h = 4 * c
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    return (randn(rows, c).bfloat16(), randn(h, c, scale=c ** -0.5).bfloat16(),
            randn(h, scale=0.1), randn(c, h, scale=h ** -0.5).bfloat16(),
            randn(rows, c).bfloat16())


def card(seeds: int) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    worst = {}
    for rows, c in CARD_SHAPES:
        for seed in range(seeds):
            args = inputs(rows, c, seed, 'cuda')
            want = fused_mlp_bwd_reference(*args)
            other = fused_mlp_bwd_reference_f64(*args)
            got = fused_mlp_bwd(*args)
            limits = fused_mlp_bwd_limits(*args, want)
            row = {}
            for name, w, o, k, lim in zip(('dW1', 'db1', 'dW2'), want[1:4],
                                          other, got[1:4], limits):
                spread = (o - w).abs().max().item()
                dev = (k - w).abs().max().item()
                row[name] = dict(max=w.abs().max().item(),
                                 spread=spread, dev=dev, limit=lim,
                                 ratio=dev / max(spread, 1e-30),
                                 of_limit=dev / lim)
                key = f'({rows}, {c}) {name}'
                worst[key] = max(worst.get(key, (0.0, 0.0)),
                                 (dev / lim, dev / max(spread, 1e-30)))
            print(json.dumps({'rows': rows, 'c': c, 'seed': seed, **row}),
                  flush=True)
    print(json.dumps({'card': smi, 'worst (of limit, of spread)': worst}),
          flush=True)


def main() -> None:
    if sys.argv[1:2] == ['--card']:
        card(int(sys.argv[2]) if len(sys.argv) > 2 else 5)
        return
    rows, c = (int(v) for v in sys.argv[1:3]) if len(sys.argv) > 2 \
        else (8400, 384)
    args = inputs(rows, c, 0)
    want = fused_mlp_bwd_reference(*args)
    other = fused_mlp_bwd_reference_f64(*args)
    for name, w, o in zip(('dW1', 'db1', 'dW2'), want[1:4], other):
        spread = (o - w).abs().max() / w.abs().max()
        print(f'{name}: max |d| / max {spread.item():.3g} '
              f'({rows} x {c}, H {4 * c}, bf16)')


if __name__ == '__main__':
    main()
