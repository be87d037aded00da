"""Shared host-side helpers: the port's own copy of
transparent_object_detection_tpu/utils/common.py (class names, seeding, the
configuration table, pixel scaling)."""
from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np
import torch


def get_classes(classes_path: str) -> Tuple[List[str], int]:
    """Read one class name per line; blank lines are skipped."""
    with open(classes_path, encoding="utf-8") as f:
        class_names = [c.strip() for c in f.readlines() if c.strip()]
    return class_names, len(class_names)


def seed_everything(seed: int = 11) -> np.random.Generator:
    """Seed Python's, numpy's and torch's default generators (torch's on
    every CUDA device too) and return a numpy Generator for the data
    pipeline."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def show_config(**kwargs) -> str:
    """Format and print a table of the keyword arguments; returns it."""
    lines = ["Configurations:", "-" * 70, "|%25s | %40s|" % ("keys", "values"), "-" * 70]
    for key, value in kwargs.items():
        lines.append("|%25s | %40s|" % (str(key), str(value)))
    lines.append("-" * 70)
    text = "\n".join(lines)
    print(text)
    return text


def preprocess_input(image: np.ndarray) -> np.ndarray:
    """Scale uint8 pixels to [0, 1]."""
    return image / 255.0
