"""Probe entry points of the port (``python -m light_whisper_tpu_torch.scripts.<name>``).

Counterparts of the reference's ``scripts/`` probes under the same file
names; they measure kernels on the card and are not serving code.
"""
