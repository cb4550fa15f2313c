"""A ``(data, coalition)`` grid of devices, driven from one process or from
several processes joined by ``torch.distributed``.

Port of ``distributedkernelshap_tpu/parallel/mesh.py``.  JAX drives a mesh
of devices from one controller per host and XLA moves the data; here each
process holds the same grid of ``torch.device``\\ s, knows which entries it
owns, issues its own shards' work from a host loop and moves the partial
sums itself (``parallel/coalition_sharding.py``, ``parallel/distributed.py``).
CUDA launches are asynchronous, so shards on distinct cards overlap.

Axis convention, as the reference's:

* ``data`` — the instance axis (minibatches over the devices);
* ``coalition`` — an optional second axis splitting one explanation's
  coalition rows (the sampled path) or background rows (the exact paths)
  across the devices of a group, whose partial sums add up exactly.

A mesh may name one device more than once: ``['cpu'] * 8`` is how the CPU
tests run an 8-device mesh, and ``[cuda:0] * 4`` how one card runs a 2×2
layout.

Several processes (the reference's ``jax.distributed``): every process
calls :func:`initialize_multihost`, then builds the mesh from its OWN
devices; the global device list is every process's list in rank order
(process-major, like ``jax.devices()``).  Cross-process data moves through
:func:`exchange`, an all-gather of tagged tensors in which every process
receives the same bytes, so every rank adds partial sums in the same
order and holds the same bits.  The collective backend is NCCL when every
rank has a card of its own and gloo otherwise (the CPU, or two ranks on
one card, which NCCL refuses); on gloo CUDA tensors go through the host.
"""

import atexit
import copy
import datetime
import json
import logging
import os
from typing import Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
COALITION_AXIS = "coalition"

#: seconds a store connection, a rendezvous or a collective may wait before
#: it raises: a peer that died must fail the others fast, not hang them
DEFAULT_TIMEOUT_S = 120.0


class _Runtime:
    """This process's multi-process runtime: the coordination store the
    ranks rendezvous and exchange host data on, and the collective backend
    chosen for the group.  One per process, as ``torch.distributed``'s
    default group is."""

    def __init__(self):
        self.store = None
        self.backend: Optional[str] = None
        self.mesh_calls = 0


_RUNTIME = _Runtime()


def local_device_count() -> int:
    """The CUDA devices this process sees."""

    return torch.cuda.device_count()


def _group_up() -> bool:
    dist = torch.distributed
    return bool(dist.is_available() and dist.is_initialized())


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 without one); the
    counterpart of ``jax.process_count``."""

    return int(torch.distributed.get_world_size()) if _group_up() else 1


def process_index() -> int:
    """This process's rank (0 without a group); ``jax.process_index``."""

    return int(torch.distributed.get_rank()) if _group_up() else 0


def collective_backend() -> Optional[str]:
    """``'nccl'`` or ``'gloo'``: the backend of the group this process
    joined, ``None`` in one process."""

    if not _group_up():
        return None
    return _RUNTIME.backend or str(torch.distributed.get_backend())


def coordination_store():
    """The key-value store every rank of the group reaches (the TCPStore
    :func:`initialize_multihost` rendezvoused on, else the default
    group's), or ``None`` in one process.  The serving fabric's host-side
    wire (``serving/multihost.KVStoreTransport``) and :func:`device_mesh`'s
    exchange of device lists run over it."""

    if _RUNTIME.store is not None:
        return _RUNTIME.store
    if _group_up():
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()
    return None


def _card_uuid() -> str:
    """The UUID of this process's current card, or ``'cpu'`` without one."""

    if not torch.cuda.is_available():
        return "cpu"
    return str(torch.cuda.get_device_properties(torch.cuda.current_device()).uuid)


def choose_backend(card_uuids: Sequence[str]) -> str:
    """The backend rule: NCCL when every rank has a card of its own, gloo
    when any rank has none (the CPU) or two ranks share one card (NCCL
    refuses two ranks on one GPU: "Duplicate GPU detected")."""

    uuids = list(card_uuids)
    if "cpu" in uuids or len(set(uuids)) < len(uuids):
        return "gloo"
    return "nccl"


def _launch_from_env():
    """``(host, port, rank, world, agent_store)`` of a ``torchrun``
    environment, or ``None`` outside one."""

    env = os.environ
    if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
        return None
    agent = env.get("TORCHELASTIC_USE_AGENT_STORE", "").lower() == "true"
    return (env["MASTER_ADDR"], int(env["MASTER_PORT"]), int(env["RANK"]),
            int(env["WORLD_SIZE"]), agent)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a multi-process runtime (reference ``mesh.py:36-88``).

    * ``coordinator_address='host:port'`` with ``num_processes`` and
      ``process_id``: rank ``process_id`` of ``num_processes`` rendezvous
      on a TCPStore at that address (rank 0 hosts it);
    * no arguments under ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``,
      ``RANK``, ``WORLD_SIZE``): the same from the environment;
    * neither: nothing happens, one process over its own devices.

    Before ``init_process_group`` the ranks exchange their cards' UUIDs
    on the store and pick the backend by :func:`choose_backend`.  An
    explicit launch that fails raises: degrading to N independent runs
    would leave every result partial.  A group that already exists is left
    alone."""

    dist = torch.distributed
    if _group_up():
        logger.info("torch.distributed already initialised (%d processes, %s)",
                    process_count(), collective_backend())
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit and coordinator_address is None:
        raise ValueError(
            "num_processes/process_id were given without coordinator_address; "
            "all three are required for an explicit multi-process launch")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address needs num_processes and process_id too")
        host, _, port = coordinator_address.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator_address must be 'host:port', got "
                             f"{coordinator_address!r}")
        launch = (host, int(port), int(process_id), int(num_processes), False)
    else:
        launch = _launch_from_env()
        if launch is None:
            logger.info("single process: the mesh spans this process's devices")
            return
    host, port, rank, world, agent_store = launch
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is outside 0..{world - 1}")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    store = dist.TCPStore(host, port, world, is_master=(rank == 0 and not agent_store),
                          timeout=timeout)
    store.set(f"dks/card/{rank}", _card_uuid())
    backend = choose_backend(store.get(f"dks/card/{r}").decode() for r in range(world))
    dist.init_process_group(backend, store=dist.PrefixStore("dks/pg", store),
                            rank=rank, world_size=world, timeout=timeout)
    _RUNTIME.store, _RUNTIME.backend = store, backend
    # the group's threads must be joined before the interpreter tears down,
    # or a process can abort on its way out
    atexit.register(shutdown_multihost)
    logger.info("torch.distributed initialised: rank %d of %d, backend %s", rank,
                world, backend)


def shutdown_multihost() -> None:
    """Leave the group this process joined (nothing without one)."""

    if _group_up():
        torch.distributed.destroy_process_group()
    _RUNTIME.store, _RUNTIME.backend = None, None


def _comm_device() -> torch.device:
    """Where a collective's buffers live: the current card on NCCL, the
    host on gloo."""

    if collective_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather_bytes(payload: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's 1-D ``uint8`` ``payload`` (lengths may differ), in rank
    order, as host tensors: two all-gathers, the lengths then the bytes
    padded to the longest."""

    dist = torch.distributed
    comm = _comm_device()
    n = torch.tensor([payload.numel()], dtype=torch.int64, device=comm)
    sizes = [torch.zeros_like(n) for _ in range(process_count())]
    dist.all_gather(sizes, n)
    sizes = [int(s.item()) for s in sizes]
    buf = torch.zeros(max(sizes), dtype=torch.uint8, device=comm)
    buf[:payload.numel()] = payload.to(comm)
    out = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(out, buf)
    return [o[:s].cpu() for o, s in zip(out, sizes)]


def exchange(local: Dict[Hashable, torch.Tensor]) -> Dict[Hashable, torch.Tensor]:
    """All-gather tagged tensors: every rank contributes ``local`` (keys
    are JSON-able tuples, unique across ranks) and receives every rank's
    entries as host tensors holding the sender's exact bytes.  The
    counterpart of ``process_allgather`` and of the reference's ``psum``
    operands; every rank must call it at the same point of the program.
    Without a group it returns host copies of ``local``."""

    entries = sorted(local.items(), key=lambda kv: repr(kv[0]))
    host = [(k, t.detach().contiguous().cpu()) for k, t in entries]
    if not _group_up():
        return dict(host)
    meta = json.dumps([[list(k) if isinstance(k, tuple) else k, str(t.dtype).split(".")[-1],
                        list(t.shape)] for k, t in host]).encode()
    parts = [torch.tensor(np.frombuffer(np.int64(len(meta)).tobytes(), np.uint8)),
             torch.tensor(np.frombuffer(meta, np.uint8))]
    parts += [t.reshape(-1).view(torch.uint8) for _, t in host]
    out: Dict[Hashable, torch.Tensor] = {}
    for raw in _all_gather_bytes(torch.cat(parts)):
        n_meta = int(np.frombuffer(raw[:8].numpy().tobytes(), np.int64)[0])
        offset = 8 + n_meta
        for key, dtype, shape in json.loads(raw[8:offset].numpy().tobytes()):
            dt = getattr(torch, dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dt).element_size()
            t = raw[offset:offset + nbytes].clone().view(dt).reshape(shape)
            out[tuple(key) if isinstance(key, list) else key] = t
            offset += nbytes
    return out


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank (a blocking collective)."""

    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    torch.distributed.broadcast(t, src=0)
    return int(t.item())


def _as_device(d: Union[str, torch.device]) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current one, so two spellings of one card compare equal."""

    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """A ``(n_data, n_coal)`` grid of ``torch.device``\\ s, each entry
    owned by one process.

    ``shape`` is ``{'data': n_data, 'coalition': n_coal}`` (the reference's
    ``Mesh.shape``); ``devices`` the object array of devices (an entry
    another process owns names that process's device); ``owners`` the
    ranks; ``rank`` this process's.  Every process builds the same grid.
    ``distinct_devices`` are this process's devices, each once, in grid
    order."""

    def __init__(self, grid: np.ndarray, owners: Optional[np.ndarray] = None,
                 rank: int = 0, world: int = 1):
        grid = np.asarray(grid, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid, got shape {grid.shape}")
        self.devices = grid
        self.owners = (np.zeros(grid.shape, np.int64) if owners is None
                       else np.asarray(owners, np.int64).reshape(grid.shape))
        self.rank = int(rank)
        #: processes the grid's collectives run over (every rank of the group,
        #: owner or not, takes part)
        self.world = int(world)
        self.shape = {DATA_AXIS: int(grid.shape[0]),
                      COALITION_AXIS: int(grid.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.devices[i, j]

    def is_local(self, i: int, j: int = 0) -> bool:
        return int(self.owners[i, j]) == self.rank

    def local_entries(self) -> List[Tuple[int, int]]:
        """The ``(i, j)`` this process owns, in grid order."""

        return [(int(i), int(j)) for i, j in zip(*np.nonzero(self.owners == self.rank))]

    def leads(self, i: int) -> bool:
        """Whether this process owns data group ``i``'s first device, where
        the group's partial sums are added and its result lives."""

        return self.is_local(i, 0)

    @property
    def multiprocess(self) -> bool:
        return self.world > 1

    @property
    def coalition_spans_processes(self) -> bool:
        """Whether some data group's devices belong to several processes
        (its partial sums then cross the process boundary)."""

        return any(len(set(row.tolist())) > 1 for row in self.owners)

    @property
    def distinct_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for i, j in self.local_entries():
            d = self.devices[i, j]
            if d not in out:
                out.append(d)
        return out

    def first_local_device(self) -> torch.device:
        """This process's first device in grid order (the host where it
        owns none)."""

        local = self.distinct_devices
        return local[0] if local else torch.device("cpu")

    def group_parts(self, parts: Dict[Tuple[int, int], Dict[str, torch.Tensor]]
                    ) -> Dict[int, List[Dict[str, torch.Tensor]]]:
        """Each data group this process leads, its coalition shards' parts in
        shard order: ``parts`` holds this process's own shards' tensors
        keyed ``(i, j)``; a shard of another process arrives through
        :func:`exchange` and is moved to the group's first device.  Every
        process calls this at the same point (the exchange is a collective
        whenever some group spans processes)."""

        remote: Dict[Hashable, torch.Tensor] = {}
        if self.multiprocess and self.coalition_spans_processes:
            remote = exchange({(i, j, name): t
                               for (i, j), named in parts.items() if not self.leads(i)
                               for name, t in named.items()})
        out: Dict[int, List[Dict[str, torch.Tensor]]] = {}
        for i in range(self.shape[DATA_AXIS]):
            if not self.leads(i):
                continue
            d0 = self.device(i, 0)
            group = []
            for j in range(self.shape[COALITION_AXIS]):
                if self.is_local(i, j):
                    group.append(parts[(i, j)])
                else:
                    group.append({k[2]: t.to(d0) for k, t in remote.items()
                                  if k[:2] == (i, j)})
            out[i] = group
        return out


def _exchange_device_lists(local: List[str]) -> List[List[str]]:
    """Every rank's device list, in rank order, through the coordination
    store (keys numbered per call: every rank builds its meshes in the same
    order)."""

    store = coordination_store()
    if store is None:
        raise RuntimeError("a mesh over several processes needs the "
                           "coordination store of initialize_multihost")
    call = _RUNTIME.mesh_calls
    _RUNTIME.mesh_calls += 1
    store.set(f"dks/mesh/{call}/{process_index()}", json.dumps(local))
    return [json.loads(store.get(f"dks/mesh/{call}/{r}").decode())
            for r in range(process_count())]


def mesh_from_lists(device_lists: Sequence[Sequence[Union[str, torch.device]]],
                    rank: int = 0, n_devices: Optional[int] = None,
                    coalition_parallel: int = 1) -> DeviceMesh:
    """The mesh over every rank's device list in rank order (process-major,
    like ``jax.devices()``), capped at ``n_devices`` with a warning, laid
    out ``(n / coalition_parallel, coalition_parallel)``."""

    flat = [(r, torch.device(d)) for r, lst in enumerate(device_lists) for d in lst]
    if n_devices is not None:
        if n_devices > len(flat):
            logger.warning(
                "Requested %d devices but only %d are attached; using %d. "
                "(The reference similarly caps the actor pool at the CPU count.)",
                n_devices, len(flat), len(flat),
            )
            n_devices = len(flat)
        flat = flat[:n_devices]
    n = len(flat)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if n % coalition_parallel != 0:
        raise ValueError(
            f"coalition_parallel={coalition_parallel} must divide the device count {n}"
        )
    shape = (n // coalition_parallel, coalition_parallel)
    grid = np.empty(shape, dtype=object)
    owners = np.empty(shape, dtype=np.int64)
    for k, (r, d) in enumerate(flat):
        grid[k // coalition_parallel, k % coalition_parallel] = d
        owners[k // coalition_parallel, k % coalition_parallel] = r
    return DeviceMesh(grid, owners, rank=rank, world=len(device_lists))


def device_mesh(n_devices: Optional[int] = None,
                coalition_parallel: int = 1,
                devices: Optional[Sequence[Union[str, torch.device]]] = None
                ) -> DeviceMesh:
    """Build a ``(data, coalition)`` mesh over ``n_devices`` devices
    (reference ``mesh.py:91-129``).

    ``devices`` are THIS process's devices; they default to every visible
    CUDA device (raising when there is none: pass ``devices=['cpu'] * n``
    to run on the CPU) and may repeat a device.  Under several processes
    the global list is every rank's, in rank order.  ``n_devices=None``
    takes all of them; more than there are is capped with a warning.
    ``coalition_parallel > 1`` puts that many devices in each data-parallel
    group, co-operating on one batch; a group may span processes."""

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [str(_as_device(d)) for d in devices]
    lists = _exchange_device_lists(local) if process_count() > 1 else [local]
    return mesh_from_lists(lists, rank=process_index(), n_devices=n_devices,
                           coalition_parallel=coalition_parallel)


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
