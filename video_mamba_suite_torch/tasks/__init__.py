"""Task pipelines of the PyTorch port: ``recognition``, ``anticipation``,
``egocentric``, ``tal`` (action localization), ``tas`` (action
segmentation) and ``vtg`` (temporal grounding and highlights)."""
