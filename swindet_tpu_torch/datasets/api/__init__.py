from .coco_api import COCO
from .cocoeval import COCOeval, Params

__all__ = ['COCO', 'COCOeval', 'Params']
