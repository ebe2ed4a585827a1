"""The benchmark of jwave_tpu_torch on a CUDA card (``run.py``)."""
