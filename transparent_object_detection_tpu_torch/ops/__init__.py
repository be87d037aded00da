"""Tensor operations of the PyTorch port."""
