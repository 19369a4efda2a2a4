"""The plain reference: Eq. 1, the exact integer scan and the float64
rerank in plain PyTorch (``eq1``, ``scan``), the comparison that decides
``correct`` (``judge``) and the lower-precision control (``control``).
It imports nothing of ``repro_torch``, and takes nothing the program has
made but what it judges."""
