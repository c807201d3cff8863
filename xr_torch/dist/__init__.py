"""Screen bands of the PyTorch port: one frame rendered as horizontal bands
over a list of devices."""
