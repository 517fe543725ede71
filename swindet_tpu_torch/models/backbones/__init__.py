from . import resnet, swin  # noqa: F401
