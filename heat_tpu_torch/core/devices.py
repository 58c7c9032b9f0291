"""Devices (reference: heat/core/devices.py:17-167).

A :class:`Device` names a kind of torch device, ``"cpu"`` or ``"gpu"``
(CUDA). Which physical devices an array's shards live on is the business of
its :class:`~heat_tpu_torch.core.communication.MeshCommunication`. The
default device is the GPU: without CUDA, creating an array raises unless the
caller asks for the CPU with ``use_device("cpu")`` or ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "sanitize_device", "use_device"]


class Device:
    """A kind of compute device on which arrays live.

    Parameters
    ----------
    device_type : str
        ``"cpu"`` or ``"gpu"``.
    device_id : int
        Kept for the reference's signature (devices.py:28); which devices
        hold the shards is the mesh's business.
    """

    def __init__(self, device_type: str, device_id: int = 0):
        self.__device_type = device_type
        self.__device_id = device_id

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> int:
        return self.__device_id

    @property
    def torch_type(self) -> str:
        """The torch device type: ``"cpu"`` or ``"cuda"``."""
        return "cuda" if self.__device_type == "gpu" else "cpu"

    def torch_devices(self):
        """Every torch device of this kind this process sees. Raises
        ``RuntimeError`` for the GPU when CUDA is not available."""
        if self.__device_type == "cpu":
            return [torch.device("cpu")]
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: heat_tpu_torch runs on the GPU unless asked "
                "for the CPU (use_device('cpu') or device='cpu')"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def __repr__(self) -> str:
        return f"device({self.__device_type!r})"

    def __str__(self) -> str:
        return self.__device_type

    def __eq__(self, other) -> bool:
        if isinstance(other, Device):
            return self.device_type == other.device_type
        if isinstance(other, str):
            try:
                return self.device_type == sanitize_device(other).device_type
            except ValueError:
                return NotImplemented
        return NotImplemented

    def __hash__(self):
        return hash(self.device_type)


cpu = Device("cpu")
"""The host CPU."""

gpu = Device("gpu")
"""The CUDA devices."""

__default_device: Device = gpu


def get_device() -> Device:
    """The currently-selected default device (reference devices.py:139)."""
    return __default_device


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Normalize a device spec to a :class:`Device` (reference devices.py:146)."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    name = str(device).strip().lower().split(":")[0]
    if name == "cpu":
        return cpu
    if name in ("gpu", "cuda"):
        return gpu
    raise ValueError(f"Unknown device, must be 'cpu' or 'gpu', got {device!r}")


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the globally-used default device (reference devices.py:157-167);
    ``None`` restores the GPU."""
    global __default_device
    __default_device = gpu if device is None else sanitize_device(device)
