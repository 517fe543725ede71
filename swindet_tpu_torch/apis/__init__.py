from .inference import (format_results, inference_detector, init_detector,
                        preprocess_images, run_batch)
from .train import set_random_seed, train_detector

__all__ = ['init_detector', 'inference_detector', 'preprocess_images',
           'format_results', 'run_batch', 'set_random_seed',
           'train_detector']
