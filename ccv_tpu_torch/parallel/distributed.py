"""Multi-process start-up of the port (counterpart of
ccv_tpu/parallel/distributed.py): ``torch.distributed`` with one process
per rank.

    from ccv_tpu_torch.parallel import distributed
    distributed.init("nccl")          # under torchrun, or CCV_TPU_* set
    mesh = distributed.global_mesh(("data",))

The caller names the backend ("nccl" for a card per rank, "gloo" for the
CPU or several ranks on one card); nothing picks it. The rendezvous comes
from the arguments, else from ``ccv_tpu``'s variables
(``CCV_TPU_COORDINATOR``, ``CCV_TPU_NUM_PROCESSES``,
``CCV_TPU_PROCESS_ID``), else from what ``torchrun`` sets (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); with none of them ``init``
returns False and the program is one process. A coordinator is a URL
(``tcp://host:port``, ``file:///path``) or ``host:port``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ccv_tpu_torch import device as _device
from ccv_tpu_torch.parallel import mesh as _mesh


def init(backend: str, coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> bool:
    """Start the process group on ``backend``; True when one is up (also
    when it already was, on the same backend), False when nothing asks for
    more than one process."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs on "
                               f"{dist.get_backend()}, not {backend}")
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "CCV_TPU_COORDINATOR")
    if num_processes is None and "CCV_TPU_NUM_PROCESSES" in env:
        num_processes = int(env["CCV_TPU_NUM_PROCESSES"])
    if process_id is None and "CCV_TPU_PROCESS_ID" in env:
        process_id = int(env["CCV_TPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in env:
            return False
        dist.init_process_group(backend, init_method="env://")
        return True
    missing = [name for name, v in (("coordinator_address",
                                     coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"distributed.init: {', '.join(missing)} not given "
                         f"(arguments or CCV_TPU_* variables)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def local_device(device: _device.DeviceLike = None) -> torch.device:
    """This rank's device: ``device`` if given, else the card of
    ``LOCAL_RANK`` (``torchrun`` sets it; 0 without it)."""
    if device is not None:
        return torch.device(device)
    _device.default_device()  # raises without a card
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def global_mesh(axis_names: Sequence[str],
                shape: Optional[Tuple[int, ...]] = None,
                device: _device.DeviceLike = None):
    """A mesh over every rank. Default shape: all ranks on the first
    axis."""
    if shape is None:
        shape = (process_count(),) + (1,) * (len(axis_names) - 1)
    return _mesh.make_mesh(dict(zip(axis_names, shape)), device)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return _mesh.world_size()
