"""Host-side helpers of the PyTorch port."""
from transparent_object_detection_tpu_torch.utils.common import (  # noqa: F401
    get_classes,
    preprocess_input,
    seed_everything,
    show_config,
)
from transparent_object_detection_tpu_torch.utils.image import cvt_color, resize_image  # noqa: F401
