"""Data pipeline of the PyTorch port (annotations, augmentation, dataset,
loader, device prefetch); counterpart of transparent_object_detection_tpu/data/."""
from transparent_object_detection_tpu_torch.data.annotations import (  # noqa: F401
    coco_category_remap,
    coco_to_annotation_lines,
    parse_annotation_line,
    read_annotation_file,
    write_annotation_file,
)
from transparent_object_detection_tpu_torch.data.dataset import (  # noqa: F401
    DetectionDataset,
    collate,
)
from transparent_object_detection_tpu_torch.data.loader import (  # noqa: F401
    DataLoader,
    device_prefetch,
)
