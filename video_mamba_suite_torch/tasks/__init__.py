"""Task pipelines of the PyTorch port: ``recognition``, ``anticipation``
and ``egocentric``."""
