from .aug_test import aug_test_single_stage, aug_test_two_stage
from .inference import (format_results, inference_detector, init_detector,
                        preprocess_images, run_batch)
from .test import single_gpu_test
from .train import set_random_seed, train_detector

__all__ = ['init_detector', 'inference_detector', 'preprocess_images',
           'format_results', 'run_batch', 'aug_test_single_stage',
           'aug_test_two_stage',
           'single_gpu_test', 'set_random_seed', 'train_detector']
