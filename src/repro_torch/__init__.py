"""PyTorch/CUDA port of the ``repro`` LM stack, for NVIDIA Hopper.

Mirrors ``src/repro/`` module for module (``repro_torch/models/layers.py``
is held against ``repro/models/layers.py``) and imports nothing of it: what
the port needs from the reference package it keeps as its own copy.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
