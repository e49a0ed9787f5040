"""Preset pattern configurations (``data/*.json``).

The port's copies of the seven presets of ``chromosight_tpu/kernels/data``,
byte for byte, read by ``chromosight_torch.io.config.load_kernel_config``.
"""
