"""Task pipelines of the PyTorch port: ``recognition`` and
``anticipation``."""
