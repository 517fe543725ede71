from . import reppoints_head, rpn_head  # noqa: F401
