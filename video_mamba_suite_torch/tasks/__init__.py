"""Task pipelines of the PyTorch port: ``recognition``, ``anticipation``,
``egocentric``, ``tal`` (action localization) and ``tas`` (action
segmentation)."""
