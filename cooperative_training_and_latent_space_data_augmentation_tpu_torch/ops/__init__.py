"""Ops of the port: the conv kernels and their dispatchers, masking, losses,
STN input construction, and the training augmentation with its B-spline warp."""
