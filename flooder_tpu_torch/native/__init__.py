"""Native code of the PyTorch port: its own C++ persistence reduction and
the build of the CUDA kernels (see ``build.py``)."""
