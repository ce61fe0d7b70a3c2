"""Device resolution for the port's entry points.

``device=None`` means the GPU. Without CUDA that is an error, never a silent
move to the CPU: the CPU runs only when the caller asks for it.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """Return the torch.device an entry point runs on.

    None resolves to ``cuda``; a CUDA device without CUDA raises.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return device
