from . import (anchor_head, fcos_head, nasfcos_head,  # noqa: F401
               reppoints_head, retina_head, rpn_head)
