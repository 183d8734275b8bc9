"""Device resolution shared by the port's entry points."""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Without one the call raises: the port
    never quietly runs on the CPU unless the caller asks for it with
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)
