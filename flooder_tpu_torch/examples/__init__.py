"""Examples of the PyTorch port, counterparts of the repository's
``examples/example_0{1..4}_*.py``. Each runs as
``python -m flooder_tpu_torch.examples.<name> [--small] [--device cpu]``
and has ``main(argv=None)``."""
