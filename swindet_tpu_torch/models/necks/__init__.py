from . import fpn, hrfpn  # noqa: F401
