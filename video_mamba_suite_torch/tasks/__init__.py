"""Task pipelines of the PyTorch port."""
