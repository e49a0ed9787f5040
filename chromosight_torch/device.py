"""Device selection and the fp32 rules the port computes under.

TF32 is off for matmuls and cuDNN convolutions: it keeps about three
decimal digits, the card's counterpart of the bf16 truncation the JAX
package avoids with ``precision=HIGHEST``.  The plain twin of the Pearson
kernel runs ``F.conv2d``, which cuDNN would otherwise run in TF32.

``upload`` and ``download`` copy maps, tables and results across the
host-device link and count their bytes (``observability.add_bytes``);
flag and index vectors (missing bins, coordinates, tile ids) are copied
plainly and not counted, as in the JAX package.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager

import numpy as np
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


def resolve_devices(devices=None):
    """The tuple of ``torch.device`` a run spreads its maps over.

    ``None`` means every visible CUDA card (and raises without one); one
    device or name means that device alone; a sequence means its devices
    in order, repeats allowed (two workers on one card).  A CUDA device
    without an index gets the current one, so equal cards compare equal.
    """
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = []
    for device in devices:
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        out.append(device)
    if not out:
        raise ValueError("no device given")
    return tuple(out)


def new_stream(device):
    """A CUDA stream of its own on ``device`` for a worker thread, or None
    on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@contextmanager
def on_stream(device, stream):
    """Work of the calling thread on ``device``: on a card, that card and
    ``stream`` are current inside (a thread's current stream is its
    own); on the CPU nothing changes."""
    with ExitStack() as ctx:
        if device.type == "cuda":
            ctx.enter_context(torch.cuda.device(device))
            ctx.enter_context(torch.cuda.stream(stream))
        yield


@contextmanager
def stage(name, device):
    """Time a pipeline stage under ``chromosight_torch.observability``.

    On a CUDA device the stage ends by synchronising the calling thread's
    current stream, so its time holds the device work it queued and not
    only the enqueue, and other threads' streams run on.  Under the
    scheduler's workers stages overlap: their sum can exceed the wall."""
    with observability.stage(name):
        yield
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()


def upload(array, device):
    """A host numpy array as a tensor on ``device``, its bytes counted as
    an upload (``observability.add_bytes``; on the CPU too, as the JAX
    package counts them on its CPU backend)."""
    array = np.ascontiguousarray(array)
    observability.add_bytes("upload", array.nbytes)
    return torch.from_numpy(array).to(device)


def download(tensor):
    """``tensor`` on the host as a numpy array, its bytes counted as a
    download (on the CPU too)."""
    observability.add_bytes("download", tensor.numel() * tensor.element_size())
    return tensor.cpu().numpy()


def reset_stages():
    """Clear the stage totals."""
    observability.reset()


def stage_seconds():
    """{stage name: seconds} accumulated since the last ``reset_stages``."""
    return observability.snapshot()[0]
