from . import fpn, hrfpn, nasfcos_fpn  # noqa: F401
