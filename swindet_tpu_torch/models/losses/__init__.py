from .losses import (CrossEntropyLoss, GIoULoss, L1Loss,  # noqa: F401
                     SmoothL1Loss, accuracy, weight_reduce_loss)
