"""Evaluation of the PyTorch port (COCO and VOC mAP, the training
callbacks); counterpart of transparent_object_detection_tpu/eval/."""
from transparent_object_detection_tpu_torch.eval.callbacks import (  # noqa: F401
    EvalCallback,
    LossHistory,
)
from transparent_object_detection_tpu_torch.eval.coco_map import coco_eval  # noqa: F401
from transparent_object_detection_tpu_torch.eval.voc_map import (  # noqa: F401
    get_map_from_dirs,
    log_average_miss_rate,
    voc_ap,
    voc_map,
)
