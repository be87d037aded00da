"""Command-line drivers of the PyTorch port, each run as
`python -m transparent_object_detection_tpu_torch.tools.<name>`: predict,
train, summary, get_map, profile and coco_annotation (the counterparts of
the JAX package's tools/*.py; each runs on CUDA unless given `--device`),
and tp_memory (per-rank parameter bytes of tensor-parallel serving, from
shapes)."""
