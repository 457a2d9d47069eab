"""Task pipelines of the PyTorch port: ``recognition``, ``anticipation``,
``egocentric``, ``tal`` (action localization), ``tas`` (action
segmentation), ``vtg`` (temporal grounding and highlights) and
``captioning`` (dense video captioning)."""
