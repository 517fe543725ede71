"""Host time of the PyTorch port's ``preprocess_images`` for one seeded
480x640 BGR uint8 image through the flagship config's test pipeline
(resize to 800x1067, normalize, pad onto the 800x1344 canvas).

    python tools/time_torch_preprocess.py [REPO_ROOT]

REPO_ROOT (default: this checkout) names the checkout whose
``swindet_tpu_torch`` is timed, so two versions can be compared on one
host. Prints the median and the range of 20 calls after one warm-up, in
ms, with the host's CPU count and torch's thread count: a host-clock
reading, of the CPU it ran on.
"""
import os
import sys
import time

import numpy as np

CONFIG = ('configs/swin/'
          'mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py')


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), '..'))
    sys.path.insert(0, root)
    import torch
    from swindet_tpu_torch.apis.inference import preprocess_images
    from swindet_tpu_torch.utils import Config
    cfg = Config.fromfile(os.path.join(root, CONFIG))
    img = np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    preprocess_images([img], cfg)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        preprocess_images([img], cfg)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f'{root}: preprocess_images 480x640 -> 800x1344: median '
          f'{np.median(times):.2f} ms (range {min(times):.2f}-'
          f'{max(times):.2f}) over 20 calls; {os.cpu_count()} CPUs, '
          f'torch {torch.get_num_threads()} threads')


if __name__ == '__main__':
    main()
