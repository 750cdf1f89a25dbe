"""Multi-host (DCN) bring-up for capture-farm decode.

SURVEY §2's parallelism table: "DCN only for multi-host batch farming" —
batched decode is embarrassingly parallel over recordings, so the
multi-host story is pure data parallelism: every host contributes its
local captures, the global mesh shards the batch over `dp`, each host
decodes its own shard, results stay host-local.  No collective is on
the decode path at all (the only cross-host traffic is process
bring-up barriers), which is exactly how a network-aware layout should
place this workload.

Bring-up is plain ``jax.distributed``: every process calls
:func:`init_distributed` with the same coordinator and its own process
id; ``jax.devices()`` then shows the global device set and the
mesh/sharding code in ``parallel.mesh`` works unchanged (it was always
written against global devices).  ``tools/multihost_dryrun.py`` runs
this end to end with two CPU processes; CI drives it in
``tests/test_multihost.py``.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# NOTE: decoder imports are deferred — several package modules build
# device constants (jnp.asarray at module scope), which initializes the
# XLA backend, and jax.distributed.initialize() must run first.


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int,
                     local_device_count: int | None = None) -> None:
    """Join the jax.distributed cluster (idempotent per process)."""
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=(list(range(local_device_count))
                          if local_device_count else None))


def global_dp_mesh() -> Mesh:
    """One data-parallel axis over every device of every host."""
    return Mesh(np.asarray(jax.devices()), axis_names=("dp",))


def decode_captures_multihost(
    cfg,
    local_captures: np.ndarray,    # f32[B_local, T] on THIS host
    local_addr: int,
    max_frames: int = 64,
):
    """Decode this host's captures as its shard of the global batch.

    Every process must call this with the same shapes; the global batch
    is the per-process batches concatenated in process order.  Returns
    the DecodedFrames for the LOCAL shard (fully addressable here).
    """
    import jax.numpy as jnp
    from trackmaker_tpu.phy.decoder import decode_capture

    mesh = global_dp_mesh()
    sharding = NamedSharding(mesh, P("dp", None))
    x = jax.make_array_from_process_local_data(
        sharding, np.asarray(local_captures, np.float32))

    @jax.jit
    def run(xs):
        return jax.vmap(
            lambda s: decode_capture(cfg, s, local_addr,
                                     max_frames=max_frames))(xs)

    res = run(x)

    def local(a):
        # host-side gather: the addressable shards live on different
        # local devices, so concatenate as numpy, in index order
        shards = sorted(a.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards],
                              axis=0)

    return jax.tree_util.tree_map(local, res)
