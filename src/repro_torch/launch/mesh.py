"""Device meshes and the H100's roofline constants.

Counterpart of ``repro.launch.mesh``.  A :class:`Mesh` is axis names over
a numpy object array of ``torch.device``s (a device may repeat, as a PE
group's may: ``core/comm.py``); the port is a single controller, so a
mesh is a placement plan, not a runtime.  :func:`make_production_mesh`
keeps the JAX package's production shapes, (16, 16) and (2, 16, 16),
over ``meta`` devices: the counterpart of the 512 fake host devices,
read as 256 or 512 H100s in hosts of :data:`HOST_DEVICES`, device ``i``
of the mesh (C order) in host ``i // 8``.  Building one allocates
nothing.

The constants are one H100 SXM's (NVIDIA's data sheet, dense rates) and
its links; :func:`axis_link` says which link an axis's collective
crosses.  In the (16, 16) mesh the 16-wide ``model`` axis spans two
hosts, so its collectives run at the network rate, not NVLink's; the
planner reports that and the rules stay the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.comm import resolve_device

# One H100 SXM (NVIDIA H100 data sheet): dense bf16 tensor-core FLOP/s,
# HBM3 bytes/s and capacity
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_PER_DEVICE = 80e9
# NVLink 4 within a host of 8 (18 links × 25 GB/s each way = 450 GB/s a
# GPU each way, NVIDIA H100 data sheet)
NVLINK_BW = 450e9
# Between hosts: one 400 Gb/s NDR InfiniBand port (ConnectX-7) a GPU, as
# on a DGX H100 (NVIDIA DGX H100 user guide: 8 single-port ConnectX-7 for
# the compute fabric) = 50 GB/s a GPU each way
NET_BW = 50e9
HOST_DEVICES = 8


class Mesh:
    """Axis names over an object array of devices (``devices.shape`` is
    the mesh shape)."""

    def __init__(self, devices: np.ndarray, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list[torch.device]:
        """The devices in C order (a device may repeat)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.device_list()})
        return f"Mesh({self.shape}, devices={kinds})"


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices``: a list of ``prod(shape)``
    devices, or one device repeated; ``None`` is the CUDA device (raising
    without one), repeated."""
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [resolve_device(devices)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ``(data, model)`` or (2, 16, 16) ``(pod, data, model)``
    over ``meta`` devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")] * math.prod(shape))


def make_host_mesh(pes: int = 1, device=None) -> Mesh:
    """A ``(pes,)`` ``model`` mesh over one device repeated: the CUDA
    device, or ``device`` when the caller names one (``"cpu"``)."""
    return make_mesh((pes,), ("model",), [resolve_device(device)] * pes)


def axis_hosts(mesh: Mesh, axes) -> int:
    """Hosts that one group of ``axes`` (a name or names) spans: the
    mesh's devices in C order fill hosts of :data:`HOST_DEVICES`, so the
    group through device 0 is representative.  A mesh of real devices is
    one host."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if any(d.type != "meta" for d in mesh.device_list()):
        return 1
    strides = {}
    st = 1
    for name, size in reversed(list(mesh.shape.items())):
        strides[name] = st
        st *= size
    flat = [0]
    for a in axes:
        flat = [f + i * strides[a] for f in flat
                for i in range(mesh.shape[a])]
    return len({f // HOST_DEVICES for f in flat})


def axis_link(mesh: Mesh, axes) -> tuple[str, float]:
    """``(link, bytes/s each way a device)`` of the slowest link a
    collective over ``axes`` crosses: NVLink within a host, the network
    across hosts."""
    if axis_hosts(mesh, axes) > 1:
        return "network", NET_BW
    return "nvlink", NVLINK_BW
