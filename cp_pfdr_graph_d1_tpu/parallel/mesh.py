"""Mesh and multi-process helpers.

The reference's only parallelism is intra-process OpenMP
(``compute_num_threads``, e.g. ``PFDR_graph_quadratic_d1_l1.cpp:31-41``).
The equivalent here is a ``jax.sharding.Mesh`` over real or virtual
devices.  The GPUs of one host are joined all to all (NVLink), so every
solver uses the flat 1-D mesh of :func:`make_mesh`; XLA lowers its
collectives to NCCL.

Multi-host execution: each host process calls
:func:`initialize_distributed` once at startup (before any other JAX
call), after which ``jax.devices()`` is the *global* device list and
:func:`make_mesh` / :func:`make_hybrid_mesh` build process-spanning
meshes.  The solver entry points in :mod:`.dp` and :mod:`.halo` place
their operands with ``jax.device_put`` + ``NamedSharding`` (each process
uploads only its addressable shards), so the same code runs unchanged on
one process or many — proven by the 2-process CPU test
(``tests/test_multihost.py``), which runs the dp and halo solvers across
process boundaries and checks them against the single-process solutions.
"""
from __future__ import annotations

import os

import numpy as np


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_count: int | None = None) -> None:
    """Initializes JAX multi-process execution for this process.

    Pass an explicit coordinator (``"host:port"``), process count and
    id; ``local_device_count`` forces that many virtual CPU devices per
    process, and the gloo collectives backend is selected so
    cross-process psum/ppermute work on CPU.

    Must be called before any other JAX API touches the backend.
    """
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count="
                f"{local_device_count}").strip()

    import jax

    platforms = (os.environ.get("JAX_PLATFORMS", "")
                 or jax.config.jax_platforms or "")
    if "cpu" in platforms:
        # cross-process collectives on the CPU backend need gloo
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(num_devices: int | None = None, axis: str = "dp"):
    """1-D data-parallel mesh over the first ``num_devices`` GLOBAL devices
    (spans processes after :func:`initialize_distributed`)."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if num_devices is None:
        num_devices = len(devs)
    if num_devices > len(devs):
        raise ValueError(f"requested {num_devices} devices, "
                         f"have {len(devs)}")
    return Mesh(np.asarray(devs[:num_devices]), (axis,))


def make_hybrid_mesh(axis: str = "dp", host_axis: str = "host"):
    """2-D ``(host, device)`` mesh: the ``axis`` dimension stays inside a
    process, ``host_axis`` crosses processes (the slower interconnect).
    Lay fast collectives on ``axis`` and slow/rare ones on ``host_axis``.
    Falls back to a 1-D mesh when running single-process.
    """
    import jax
    from jax.sharding import Mesh

    nproc = jax.process_count()
    if nproc == 1:
        return make_mesh(axis=axis)
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    local = len(devs) // nproc
    return Mesh(np.asarray(devs).reshape(nproc, local), (host_axis, axis))


def put_sharded(x, mesh, spec):
    """Uploads a (replicated-on-every-process) host array as a global
    array sharded per ``spec`` — each process places only its addressable
    shards, which is what makes the dp/halo entry points process-count
    agnostic."""
    import jax
    from jax.sharding import NamedSharding

    return jax.device_put(x, NamedSharding(mesh, spec))
