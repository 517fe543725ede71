from . import (bbox_heads, cascade_roi_head, htc_roi_head,  # noqa: F401
               mask_heads, roi_extractor, shared_heads, standard_roi_head)
