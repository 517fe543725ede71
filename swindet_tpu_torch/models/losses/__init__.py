from .losses import (CrossEntropyLoss, FocalLoss, GIoULoss,  # noqa: F401
                     L1Loss, SmoothL1Loss, accuracy, weight_reduce_loss)
