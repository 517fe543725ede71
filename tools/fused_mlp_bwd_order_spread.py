"""How far the plain fused-MLP backward moves when only the summation
order of its fp32 sums changes, in a bf16 run (CPU).

    python tools/fused_mlp_bwd_order_spread.py [ROWS C]

``fused_mlp_bwd_reference`` rounds the activation and dh to bf16 from
fp32 values; here fc1 and g @ W2 are summed in float64 and rounded once
instead of summed in fp32, everything else the same. Prints, for dW1,
db1 and dW2, max |d| over the largest entry: the spread that any other
summation order (a kernel's) can show against the plain version. Default
shape: Swin-T stage 3 (8,400 rows, C 384, H 1,536), seeded inputs.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from swindet_tpu_torch.ops.fused_mlp import (  # noqa: E402
    _gelu, _gelu_grad, fused_mlp_bwd_reference)


def main() -> None:
    rows, c = (int(v) for v in sys.argv[1:3]) if len(sys.argv) > 2 \
        else (8400, 384)
    h = 4 * c
    torch.manual_seed(0)
    x = torch.randn(rows, c).bfloat16()
    w1 = (torch.randn(h, c) * c ** -0.5).bfloat16()
    b1 = torch.randn(h) * 0.1
    w2 = (torch.randn(c, h) * h ** -0.5).bfloat16()
    g = torch.randn(rows, c).bfloat16()
    _, dw1, db1, dw2, _ = fused_mlp_bwd_reference(x, w1, b1, w2, g)
    hid = (x.double() @ w1.double().t()).float() + b1
    a = _gelu(hid).bfloat16().float()
    dh = ((g.double() @ w2.double()).float()
          * _gelu_grad(hid)).bfloat16().float()
    other = {'dW1': dh.t() @ x.float(), 'db1': dh.sum(0),
             'dW2': g.float().t() @ a}
    for name, want in (('dW1', dw1), ('db1', db1), ('dW2', dw2)):
        spread = (other[name] - want).abs().max() / want.abs().max()
        print(f'{name}: max |d| / max {spread.item():.3g} '
              f'({rows} x {c}, H {h}, bf16)')


if __name__ == '__main__':
    main()
