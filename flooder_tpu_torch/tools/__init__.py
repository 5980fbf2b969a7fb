"""Measurement tools of the PyTorch port, built on its own engine.

- :mod:`.scene`: ``build_scene``, the flood engine's operands for one
  cloud and landmark count, exactly as ``flood_complex`` prepares them.
- :mod:`.kernel_stats`: the flood kernel's realized work, counted by
  kernel K3 (``python -m flooder_tpu_torch.tools.kernel_stats``).
"""
