from .losses import (CrossEntropyLoss, L1Loss, accuracy,  # noqa: F401
                     weight_reduce_loss)
