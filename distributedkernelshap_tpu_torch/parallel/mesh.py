"""A ``(data, coalition)`` grid of devices driven from one process.

Port of ``distributedkernelshap_tpu/parallel/mesh.py``.  JAX drives a mesh
of devices from one controller and XLA moves the data; here one process
holds a grid of ``torch.device``\\ s, issues each shard's work on its
device from a host loop and moves the partial sums itself
(``parallel/coalition_sharding.py``, ``parallel/distributed.py``).  CUDA
launches are asynchronous, so shards on distinct cards overlap.

Axis convention, as the reference's:

* ``data`` — the instance axis (minibatches over the devices);
* ``coalition`` — an optional second axis splitting one explanation's
  coalition rows (the sampled path) or background rows (the exact paths)
  across the devices of a group, whose partial sums add up exactly.

A mesh may name one device more than once: ``['cpu'] * 8`` is how the CPU
tests run an 8-device mesh, and ``[cuda:0] * 4`` how one card runs a 2×2
layout.  Several processes (``torch.distributed``, one card each) are
ROADMAP.md queue A item 10.
"""

import copy
import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
COALITION_AXIS = "coalition"


def local_device_count() -> int:
    """The CUDA devices this process sees."""

    return torch.cuda.device_count()


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def check_single_process(what: str = "a device mesh") -> None:
    """Raise where ``torch.distributed`` runs more than one process: a mesh
    across processes is ROADMAP.md queue A item 10."""

    world = _world_size()
    if world > 1:
        raise NotImplementedError(
            f"{what} over several processes (torch.distributed world size "
            f"{world}) is ROADMAP.md queue A item 10 and not ported yet; "
            "this process drives its own devices only")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join a multi-process runtime (reference ``mesh.py:40-88``).

    In one process this does nothing: the mesh is this process's devices.
    An explicit coordinator, or a world size above 1, asks for several
    processes, which is ROADMAP.md queue A item 10: it raises
    ``NotImplementedError`` rather than run N independent copies whose
    results would each be partial."""

    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit and coordinator_address is None:
        raise ValueError(
            "num_processes/process_id were given without coordinator_address; "
            "all three are required for an explicit multi-process launch")
    if coordinator_address is not None or (num_processes or 1) > 1:
        raise NotImplementedError(
            f"a multi-process launch (coordinator {coordinator_address!r}, "
            f"{num_processes} processes) is ROADMAP.md queue A item 10 and not "
            "ported yet; run one process over its local devices")
    check_single_process("initialize_multihost")
    logger.info("single process: the mesh spans this process's devices")


def _as_device(d: Union[str, torch.device]) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current one, so two spellings of one card compare equal."""

    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """A ``(n_data, n_coal)`` grid of ``torch.device``\\ s.

    ``shape`` is ``{'data': n_data, 'coalition': n_coal}`` (the reference's
    ``Mesh.shape``); ``devices`` the object array of devices; ``device(i,
    j)`` one entry; ``distinct_devices`` each device once, in grid order."""

    def __init__(self, grid: np.ndarray):
        grid = np.asarray(grid, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid, got shape {grid.shape}")
        self.devices = grid
        self.shape = {DATA_AXIS: int(grid.shape[0]),
                      COALITION_AXIS: int(grid.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.devices[i, j]

    @property
    def distinct_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in self.devices.ravel():
            if d not in out:
                out.append(d)
        return out


def device_mesh(n_devices: Optional[int] = None,
                coalition_parallel: int = 1,
                devices: Optional[Sequence[Union[str, torch.device]]] = None
                ) -> DeviceMesh:
    """Build a ``(data, coalition)`` mesh over ``n_devices`` devices
    (reference ``mesh.py:91-129``).

    ``devices`` defaults to every visible CUDA device (raising when there is
    none: pass ``devices=['cpu'] * n`` to run on the CPU) and may repeat a
    device.  ``n_devices=None`` takes all of them; more than there are is
    capped with a warning.  ``coalition_parallel > 1`` puts that many
    devices in each data-parallel group, co-operating on one batch."""

    check_single_process()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_as_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            logger.warning(
                "Requested %d devices but only %d are attached; using %d. "
                "(The reference similarly caps the actor pool at the CPU count.)",
                n_devices, len(devices), len(devices),
            )
            n_devices = len(devices)
        devices = devices[:n_devices]

    n = len(devices)
    if n % coalition_parallel != 0:
        raise ValueError(
            f"coalition_parallel={coalition_parallel} must divide the device count {n}"
        )
    grid = np.empty((n // coalition_parallel, coalition_parallel), dtype=object)
    for k, d in enumerate(devices):
        grid[k // coalition_parallel, k % coalition_parallel] = d
    return DeviceMesh(grid)


def pad_to_multiple(n: int, k: int) -> Tuple[int, int]:
    """Smallest ``m >= n`` with ``m % k == 0``; returns ``(m, m - n)``."""

    m = ((n + k - 1) // k) * k
    return m, m - n


class PerDevice(dict):
    """One tensor per distinct device, keyed by ``str(device)``: the
    per-fit constants a sharded function reads on each shard's device."""

    def on(self, device: torch.device) -> torch.Tensor:
        return self[str(device)]


def replicate(value, devices: Sequence[torch.device]) -> PerDevice:
    """``value`` (a tensor or an array) copied once to each device."""

    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    return PerDevice({str(d): t.to(d) for d in devices})


class PredictorReplicas:
    """A predictor on each device of a mesh: the original where it already
    lies, elsewhere a copy made once (an ``nn.Module`` deep-copied and
    moved with ``.to``)."""

    def __init__(self, predictor):
        self.predictor = predictor
        self._copies: Dict[str, object] = {}

    def on(self, device: torch.device):
        if _predictor_device(self.predictor) == device:
            return self.predictor
        key = str(device)
        if key not in self._copies:
            self._copies[key] = copy.deepcopy(self.predictor).to(device)
        return self._copies[key]


def _predictor_device(predictor) -> torch.device:
    dev = getattr(predictor, "_device", None)
    return _as_device(dev()) if callable(dev) else torch.device("cpu")
