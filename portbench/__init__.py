"""The benchmark of `fhe_sorting_tpu_torch`, the PyTorch and CUDA port, on NVIDIA H100 cards.

`run.py` runs one cell; `harness.py` finds the cell's configuration,
traffic and metrics by name; `reference/` is the plain decryption the
outputs are judged by; `sol.py` the frozen roofline arithmetic; `control.py`
takes the readings the limits are set from.  Nothing here imports JAX or
the JAX package.
"""
