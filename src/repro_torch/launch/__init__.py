"""Process launch for multi-rank runs (``launch.ranks``)."""
