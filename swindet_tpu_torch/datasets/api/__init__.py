from .coco_api import COCO

__all__ = ['COCO']
