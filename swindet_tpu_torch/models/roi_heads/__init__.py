from . import (bbox_heads, cascade_roi_head, mask_heads,  # noqa: F401
               roi_extractor, shared_heads, standard_roi_head)
