"""Entry points of the PyTorch port: the frame-loop runner (``run``), the
shader hot-reload preview (``watch``) and one thin wrapper a preset."""
