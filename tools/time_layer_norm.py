"""Device time of the LayerNorm kernels (``csrc/layer_norm.cu``, row 1) at
the shapes of the norms of Swin-T and Swin-B on one 800x1344 canvas, in
bf16, on one CUDA card, and the sums over a forward's launches.

    python tools/time_layer_norm.py [REPO_ROOT ...]

Each REPO_ROOT (default: this checkout) names a checkout whose
``swindet_tpu_torch`` is timed, each in a process of its own, so two
versions (a parent and a change, in turns) compare on one card in one
call:

    python tools/time_layer_norm.py build/parent . . build/parent

The shapes are chip_smoke.py's ``LN_SHAPES`` (rows at batch 1, C), taken
from the chip_smoke.py beside this tool whatever the REPO_ROOT, as are
its timers (``cuda_ms``, ``_kernel_device_ms``) and ``bound``. Swin-T's
(Swin-S's) norms at each: the patch embedding's, stage 1's four block
norms and its output norm (67,200 x 96, 6); the first merge norm (16,800
x 384, 1); stage 2's four and its output norm (16,800 x 192, 5); the
second merge norm (4,200 x 768, 1); stage 3's twelve and its output norm
(4,200 x 384, 13); the third merge norm (1,050 x 1,536, 1); stage 4's
four and its output norm (1,050 x 768, 5). Swin-B's are 4/3 as wide (C
128 ... 2,048) with 36 block norms in stage 3. Each runs at batch 1 (a
request) and batch 2 (a training step's forward; its backward is plain
torch). Inputs are seeded, x ~ 2 N(0, 1) + 0.5, fp32 weight and bias.
Prints one JSON line per checkout: the card's name and power limit as
nvidia-smi reports them; for each model, batch and shape ``ms``, the
mean ms of 20 calls after 3 warm-ups by CUDA events around them (a
call's host work included where it is longer than the kernel);
``device_ms``, the kernel's own device time per call from torch.profiler
over 20 more back-to-back calls (x stays in the 50 MB L2 from one call
to the next where x and y fit there); ``cold_device_ms``, the same with
the L2 flushed before each call (a 128 MB fill, not counted);
``first_device_ms``, back to back, of the first kernel (a warp a row),
which x copied one element past a 16-byte boundary takes;
``library_device_ms``, the device time of ``F.layer_norm`` on the same x
with the weight and bias in x's dtype (a yardstick; the port never calls
it); ``bound_ms``, the bytes (x read once, y written once, weight and
bias) over 3.35 TB/s; and for each model and batch the sums of the
device times and of the bound over the forward's launches (``step_*``).
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
# the norms of a forward at each of chip_smoke.LN_SHAPES, and the factor
# of the widths, by model
MODELS = {'swin-t': ((6, 1, 5, 1, 13, 1, 5), 1),
          'swin-b': ((6, 1, 5, 1, 37, 1, 5), 4 / 3)}


def _chip_smoke():
    """This checkout's chip_smoke.py, its imports of swindet_tpu_torch
    resolved in the checkout that is timed."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from swindet_tpu_torch.ops import layer_norm
    if not torch.cuda.is_available():
        raise SystemExit('time_layer_norm: needs a CUDA device')
    cs = _chip_smoke()

    def device_ms(fn, key='swindet'):
        return cs._kernel_device_ms(fn, {'k': key}, iters=20)['k']

    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device='cuda')
    out = {}
    for model, (counts, widen) in MODELS.items():
        for batch in (1, 2):
            rows = {}
            for (n, c0), count in zip(cs.LN_SHAPES, counts, strict=True):
                c = int(c0 * widen)
                x = ((torch.randn(batch * n, c, generator=gen) * 2 + 0.5)
                     .cuda().bfloat16())
                w = torch.randn(c, generator=gen).cuda()
                b = torch.randn(c, generator=gen).cuda()
                wd, bd = w.bfloat16(), b.bfloat16()
                off = torch.empty(x.numel() + 1, dtype=x.dtype,
                                  device='cuda')[1:].view(x.shape).copy_(x)
                rows[f'({batch * n}, {c})'] = dict(
                    launches=count,
                    ms=cs.cuda_ms(lambda: layer_norm(x, w, b), warmup=3,
                                  iters=20),
                    device_ms=device_ms(lambda: layer_norm(x, w, b)),
                    cold_device_ms=device_ms(
                        lambda: (flush.zero_(), layer_norm(x, w, b))),
                    first_device_ms=device_ms(
                        lambda: layer_norm(off, w, b)),
                    library_device_ms=device_ms(
                        lambda: F.layer_norm(x, (c,), wd, bd), key=''),
                    bound_ms=cs.bound(2 * cs._nbytes(x) + cs._nbytes(w, b),
                                      8.0 * x.numel())[0])
            out[f'{model} batch {batch}'] = dict(shapes=rows, **{
                f'step_{k}': sum(r['launches'] * r[k] for r in rows.values())
                for k in ('device_ms', 'cold_device_ms', 'first_device_ms',
                          'library_device_ms', 'bound_ms')})
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({'root': root, 'card': smi, **out}), flush=True)


def main() -> None:
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [HERE]
    if len(roots) == 1:
        run(roots[0])
        return
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       check=True, timeout=900)


if __name__ == '__main__':
    main()
