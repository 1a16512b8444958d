"""The PyTorch/CUDA port's benchmark harness (``python3 benchmark_torch/run.py``).

Everything that measures lives here, apart from the program: traffic from a
seed, the Q8_0 artifact writer, the wire client, the work and roofline
arithmetic, the trace reduction and the plain float32 reference that decides
``correct``. What differs between architectures (a decoder's sizes, tensors,
reference and work counts) is in ``archs/<arch>.py``, one module each.
Nothing here imports JAX or the JAX package.
"""
