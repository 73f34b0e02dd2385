"""Plain PyTorch references of what the benchmark's cells run.

Written from the published DUSty architecture and training recipe
(Nakashima & Kurazume, IROS 2021; kazuto1011/dusty-gan), functional, in
float32 with TF32 off.  Nothing here imports ``jax``, ``dusty_gan_tpu`` or
``dusty_gan_torch``: the reference works out again whatever the program
derives, from the inputs the benchmark makes.

``Precision`` names where the program rounds (its bf16 compute) and lets a
control round there to a lower precision instead (fp8, ``precision.py``).
"""
