"""Device time of the fused-MLP kernels at the Swin-T shapes of the
SWINDET_FUSED_MLP=1 configuration, in bf16, on one CUDA card.

    python tools/time_fused_mlp.py [REPO_ROOT ...]

Each REPO_ROOT (default: this checkout) names a checkout whose
``swindet_tpu_torch`` is timed, each in a process of its own, so two
versions (a parent and a change, in turns) compare on one card in one
call. The forward runs at the serving rows of stages 1-3 (67,200 x 96,
16,800 x 192, 4,200 x 384 for one 800x1344 image) and at the training
rows of stage 1 (batch 2), the backward at the training rows of stages
1-3; inputs are seeded. Prints one JSON line per checkout: the card's
name and power limit as nvidia-smi reports them, and the mean ms of 20
launches after 3 warm-ups (CUDA events) of each call.
"""
import json
import os
import subprocess
import sys

FWD = ((67200, 96), (16800, 192), (4200, 384), (134400, 96))
BWD = ((134400, 96), (33600, 192), (8400, 384))


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


def run(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from swindet_tpu_torch.ops import fused_mlp, fused_mlp_bwd
    if not torch.cuda.is_available():
        raise SystemExit('time_fused_mlp: needs a CUDA device')
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).cuda().to(dtype)

    def inputs(rows, c):
        h = 4 * c
        return (randn(rows, c), randn(h, c, scale=c ** -0.5),
                randn(h, scale=0.1, dtype=torch.float32),
                randn(c, h, scale=h ** -0.5),
                randn(c, scale=0.1, dtype=torch.float32), randn(rows, c))

    out = {}
    for rows, c in FWD:
        x, w1, b1, w2, b2, _ = inputs(rows, c)
        out[f'fused_mlp ({rows}, {c})'] = _time(
            lambda: fused_mlp(x, w1, b1, w2, b2))
    for rows, c in BWD:
        x, w1, b1, w2, _, g = inputs(rows, c)
        out[f'fused_mlp_bwd ({rows}, {c})'] = _time(
            lambda: fused_mlp_bwd(x, w1, b1, w2, g))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({'root': root, 'card': smi, 'ms': out}), flush=True)


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
