from . import (anchor_head, atss_head, fcos_head, gfl_head,  # noqa: F401
               ld_head, nasfcos_head, paa_head, reppoints_head, retina_head,
               rpn_head, vfnet_head)
