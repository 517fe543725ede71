from . import anchor_head, reppoints_head, retina_head, rpn_head  # noqa: F401
