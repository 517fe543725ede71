from .losses import (CrossEntropyLoss, DistributionFocalLoss,  # noqa: F401
                     FocalLoss, GIoULoss, IoULoss,
                     KnowledgeDistillationKLDivLoss, L1Loss, MSELoss,
                     QualityFocalLoss, SmoothL1Loss, VarifocalLoss, accuracy,
                     weight_reduce_loss)
