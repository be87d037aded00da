"""Training step of the PyTorch port (loss, assigner, optimizer, EMA,
schedules); counterpart of transparent_object_detection_tpu/train/."""
