from . import hrnet, regnet, res2net, resnest, resnet, swin  # noqa: F401
