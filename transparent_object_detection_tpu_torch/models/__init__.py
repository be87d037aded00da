"""Detector modules of the PyTorch port."""
