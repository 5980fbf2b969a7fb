"""Device operators of the PyTorch port: FPS, bounding balls and the CUDA
flood engine, each kernel beside its plain PyTorch version."""
