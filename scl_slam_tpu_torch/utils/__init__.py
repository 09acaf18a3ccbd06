"""Logging and timing utilities of the PyTorch port."""
