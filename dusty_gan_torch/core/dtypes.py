"""Mixed-precision policy (``dusty_gan_tpu/core/dtypes.py``).

``enable_amp`` (the reference config's flag) on means bf16 compute for G's
convolutions and D's interior; parameters, Adam state, the EMA, losses and
penalties stay float32.  bf16 has float32's exponent range, so no gradient
scaler is needed.  The compute dtype is passed to the modules explicitly
(``compute_dtype``); nothing runs under autocast.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.bfloat16


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def policy_from_cfg(enable_amp: bool) -> Policy:
    """amp on -> bf16 compute, off -> float32 throughout."""
    return DEFAULT_POLICY if enable_amp else FP32_POLICY
