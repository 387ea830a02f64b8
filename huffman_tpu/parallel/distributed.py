"""Multi-host initialization and mesh construction.

The reference has no distributed backend at all (SURVEY §2); this module
is the framework's `jax.distributed` entry point for multi-host runs.

Usage on each host (a GPU cluster names its coordinator explicitly):

    from huffman_tpu.parallel import distributed
    distributed.initialize(coordinator_address="host0:1234",
                           num_processes=2, process_id=0)
    mesh = distributed.pod_mesh(stream_per_host=True)

Design notes (see SCALING.md): the `data` axis carries no communication,
so it spans hosts freely; the `stream` axis psums 1 KiB histograms per
block and is best kept within one host, whose cards share NVLink.
`pod_mesh` therefore maps `stream` onto each host's local devices and
`data` across hosts by default.
"""

from __future__ import annotations

import numpy as np


#: Resolution state for this process: None (nothing decided yet),
#: "initialized" (jax.distributed is up), or "noop" (auto-detection found
#: no cluster — a LATER call with explicit kwargs still proceeds).
#: (Inferring from ``jax.process_count() > 1`` was wrong: it is 1 before
#: AND after a single-host init, so every call re-entered initialize().)
_state: str | None = None


def initialize(**kwargs) -> None:
    """Initialize jax.distributed once per process.

    * Explicit ``kwargs`` (coordinator_address, num_processes, ...): a
      failure propagates — a misconfigured multi-host job must not be
      silently demoted to single-process.
    * No kwargs: auto-detection runs; "no cluster found" (ValueError:
      coordinator_address should be defined) means a single-process run
      and is a no-op.  Any other error propagates.
    * Once initialized, further calls are no-ops.  A no-kwargs no-op does
      NOT latch against a later explicit-kwargs call.
    """
    global _state
    if _state == "initialized" or (_state == "noop" and not kwargs):
        return
    import jax

    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise  # genuine failure, not double-initialization
    except ValueError:
        if kwargs:
            raise  # explicit config that fails must surface
        # Auto-detection found no cluster: single-process environment.
        _state = "noop"
        return
    _state = "initialized"


def pod_mesh(stream: int | None = None, stream_per_host: bool = False):
    """Mesh over all global devices.

    Args:
      stream: explicit stream-axis size (must divide device count).
      stream_per_host: if True, the stream axis size = local device
        count, confining the histogram psum to one host.
    """
    import jax

    if stream is None:
        stream = jax.local_device_count() if stream_per_host else 1
    devices = np.asarray(jax.devices())
    # Order devices host-major so stream groups are intra-host.
    devices = devices[np.argsort([d.process_index * 1000 + d.id for d in devices])]
    from .sharded import make_mesh  # deferred: initializes the backend

    return make_mesh(devices=devices, stream=stream)
