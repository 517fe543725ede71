"""Device time of the NMS kernels (``csrc/nms.cu``: the over-threshold
bitmask and the scan, each apart) at the three NMS shapes of the main
path, on one CUDA card.

    python tools/time_nms.py [REPO_ROOT ...]

Each REPO_ROOT (default: this checkout) names a checkout whose
``swindet_tpu_torch`` is timed, each in a process of its own, so two
versions (a parent and a change, in turns) compare on one card in one
call:

    python tools/time_nms.py build/parent . . build/parent

The shapes: the training step's RPN (B 2, N 8,819 per image, IoU 0.7,
1,000 kept), serving's RPN (B 1, N 4,819, IoU 0.7, 1,000) and the bbox
head's multiclass NMS (B 1, N 2,048, IoU 0.5, 100). The candidates are
chip_smoke.py's: proposal-like boxes over an 800x1344 canvas shifted by
their RPN level's or class's offset, as batched_nms hands them over,
uniform scores, 5 % invalid, sorted by score; seeded. Prints one JSON
line per checkout: the card's name and power limit as nvidia-smi
reports them; ``ms``, the mean ms of 20 calls after 3 warm-ups by CUDA
events around them; ``mask_ms`` and ``scan_ms``, each kernel's own
device time per call from torch.profiler over 20 more calls; and
``blocks``, the 64-box blocks the greedy scan must visit per image (to
the block of the last kept box where max_out are kept).
"""
import json
import os
import subprocess
import sys

# (B, N, offset groups, IoU threshold, max kept)
SHAPES = ((2, 8819, 5, 0.7, 1000), (1, 4819, 5, 0.7, 1000),
          (1, 2048, 80, 0.5, 100))


def _inputs(gen, b, n, groups):
    import torch
    u = torch.rand(b * n, 5, generator=gen)
    size = 8.0 * 100.0 ** u[:, 0]
    aspect = 3.0 ** (2 * u[:, 1] - 1)
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    cx, cy = u[:, 2] * 1344, u[:, 3] * 800
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    boxes[:, 0::2] = boxes[:, 0::2].clamp(0, 1344)
    boxes[:, 1::2] = boxes[:, 1::2].clamp(0, 800)
    boxes = boxes.reshape(b, n, 4)
    ids = torch.randint(0, groups, (b, n), generator=gen).float()
    boxes = boxes + (ids * (boxes.amax(dim=(1, 2))[:, None] + 1.0))[..., None]
    valid = torch.rand(b, n, generator=gen) > 0.05
    score = torch.where(valid, torch.rand(b, n, generator=gen), -torch.inf)
    order = torch.sort(-score, dim=1, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return [t.cuda().contiguous() for t in (
        boxes, torch.gather(score, 1, order), torch.gather(valid, 1, order),
        order)]


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


def _device_ms(fn, names, iters=20):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return [sum(e.device_time_total for e in events if name in e.key)
            / 1e3 / iters for name in names]


def run(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from swindet_tpu_torch.ops import nms_sorted
    if not torch.cuda.is_available():
        raise SystemExit('time_nms: needs a CUDA device')
    gen = torch.Generator().manual_seed(0)
    out = {}
    for b, n, groups, thr, max_out in SHAPES:
        args = _inputs(gen, b, n, groups)
        key = f'B {b} N {n} IoU {thr} max {max_out}'
        _, inds, count = nms_sorted(*args, thr, max_out)
        inv = torch.argsort(args[3], dim=1)
        blocks = [int(inv[i][inds[i, max_out - 1]]) // 64 + 1
                  if int(count[i]) == max_out else -(-n // 64)
                  for i in range(b)]
        fn = lambda: nms_sorted(*args, thr, max_out)  # noqa: E731
        mask_ms, scan_ms = _device_ms(fn, ('nms_mask_kernel',
                                           'nms_scan_kernel'))
        out[key] = dict(ms=_time(fn), mask_ms=mask_ms, scan_ms=scan_ms,
                        kept=count.tolist(), blocks=blocks)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({'root': root, 'card': smi, 'nms': out}), flush=True)


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
