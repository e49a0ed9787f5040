"""Device selection and the fp32 rules the port computes under.

TF32 is off for matmuls and cuDNN convolutions: it keeps about three
decimal digits, the card's counterpart of the bf16 truncation the JAX
package avoids with ``precision=HIGHEST``.  The plain twin of the Pearson
kernel runs ``F.conv2d``, which cuDNN would otherwise run in TF32.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from chromosight_torch import observability

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """The ``torch.device`` the caller asks for.

    ``None`` means the first CUDA card.  The CPU is used only when the
    caller asks for it (``"cpu"``).  Asking for CUDA, or for nothing,
    without a card raises; it never falls back to the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use cpu or cuda")
    return device


@contextmanager
def stage(name, device):
    """Time a pipeline stage under ``chromosight_torch.observability``.

    On a CUDA device the stage ends with a synchronize, so its time holds
    the device work it queued and not only the enqueue."""
    with observability.stage(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def reset_stages():
    """Clear the stage totals."""
    observability.reset()


def stage_seconds():
    """{stage name: seconds} accumulated since the last ``reset_stages``."""
    return observability.snapshot()[0]
