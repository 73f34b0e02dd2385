"""dusty_gan_torch — the PyTorch/CUDA port of ``dusty_gan_tpu``.

Module names mirror the JAX package so each file has an obvious
counterpart there.  Inside, it is PyTorch idiom: ``nn.Module``s in NCHW
whose ``state_dict()`` keys are the reference ``.pth`` keys, plain tensor
functions, an explicit ``device`` and explicit ``torch.Generator``s for
every random draw.  The public functions of the evaluation path take and
return the JAX package's layouts: images (B, H, W, 1), clouds (B, N, 3).

Hand-written CUDA kernels live in ``csrc/`` and are built at first use
(``kernels.py``); each wrapper runs its plain PyTorch version for CPU
tensors and launches the kernel, or raises, for CUDA tensors.
"""

from __future__ import annotations

import contextlib

__version__ = "0.1.0"

# torch is imported inside the functions: the preprocessing pool's spawned
# workers import this package and need only numpy and the native library


def resolve_device(device=None):
    """``None`` means ``cuda``; returns a ``torch.device``.  Asking for CUDA
    without a visible GPU raises instead of quietly running on the CPU; the
    CPU must be asked for."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA GPU was requested but torch.cuda.is_available() is "
                "False: no GPU is visible to this process (pass "
                "--device cpu / device='cpu' to run on the CPU)"
            )
        set_metric_precision()
    return dev


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock around it measures the work and not its enqueue."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms inside, its setting restored after.
    cuDNN's default float32 engines for some convolutions (the ConvTs'
    forward and weight gradients) sum with atomics, so two calls on the
    same inputs can part in the last bits; under the pin they repeat."""
    import torch

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def set_metric_precision() -> None:
    """Metric math runs in true f32: TF32 keeps ~3 decimal digits, which
    moves nearest-neighbour distances, SWD projections and the depth
    pipeline.  The JAX package pins the same for its metric path."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
