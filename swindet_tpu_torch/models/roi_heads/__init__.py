from . import (bbox_heads, cascade_roi_head, double_roi_head,  # noqa: F401
               dynamic_roi_head, htc_roi_head, mask_heads,
               mask_scoring_roi_head, roi_extractor, shared_heads,
               standard_roi_head)
