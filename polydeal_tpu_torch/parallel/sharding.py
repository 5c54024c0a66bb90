"""Process groups and the static halo metadata of the sharded solve.

Counterpart of ``polydeal_tpu/parallel/sharding.py``'s ``make_mesh`` and
``build_halo_exchange``.  A JAX device mesh becomes a ``torch.distributed``
process group, one process (rank) per shard: :func:`init_group` starts it
with NCCL on CUDA devices and gloo on the CPU, through a ``FileStore`` (no
network), with a timeout so that a rank that never arrives fails the run
instead of hanging it.  :func:`build_halo_exchange` is a jax-free copy of
the JAX package's host function (``tests/test_torch_sharded.py`` holds it
equal to the original).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_group", "build_halo_exchange"]


def init_group(rank: int, world_size: int, *, device, store_path: str,
               timeout: float = 120.0):
    """Join the default process group as ``rank`` of ``world_size``: NCCL
    when ``device`` is a CUDA device (made this process's current device),
    gloo otherwise.  Every rank passes the same ``store_path`` (a file in a
    directory they share; it must not hold an earlier run's store).
    ``timeout`` seconds bound every collective.  Returns the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=store, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def build_halo_exchange(cols: np.ndarray, per: int, n_dev: int):
    """Static halo metadata from the sharded sparsity: which rows each shard
    ships to which neighbour, computed once on the host (the reference's
    ghost machinery, agglomeration_handler.cc:1026-1091, recast as static
    lists; one exchange per neighbour distance at SpMV time).

    cols: [n_dev, nnz_per] global block-column ids per shard.
    Returns (remapped_cols [n_dev, nnz_per], deltas, n_sends, sends):
    shard j sends its local rows ``sends[t][j]`` to shard (j + deltas[t])
    % n_dev, and a shard's remapped cols index [local rows | halo segment 0
    | halo segment 1 | ...]."""
    cols = np.asarray(cols)
    owner = cols // per
    # per-shard sorted unique remote cols, grouped by cyclic distance
    need = []
    deltas = set()
    for d in range(n_dev):
        remote = np.unique(cols[d][owner[d] != d])
        need.append(remote)
        # delta = (needer - owner) mod n_dev, matching the send routing
        # dst = (sender + delta) below
        deltas.update(((d - remote // per) % n_dev).tolist())
    deltas = tuple(sorted(int(x) for x in deltas))
    sends = []
    recv_maps = [{} for _ in range(n_dev)]  # global col -> halo slot
    halo_off = [per] * n_dev
    for delta in deltas:
        lists = []
        for j in range(n_dev):
            dst = (j + delta) % n_dev
            mine = need[dst][need[dst] // per == j]
            lists.append(np.sort(mine) - j * per)
        n_send = max((len(x) for x in lists), default=0)
        n_send = max(n_send, 1)
        send = np.zeros((n_dev, n_send), dtype=np.int32)
        for j in range(n_dev):
            send[j, : len(lists[j])] = lists[j]
            dst = (j + delta) % n_dev
            for pos, lr in enumerate(lists[j]):
                recv_maps[dst][j * per + int(lr)] = halo_off[dst] + pos
        for d in range(n_dev):
            halo_off[d] += n_send
        sends.append(send)
    remap = np.empty_like(cols, dtype=np.int32)
    for d in range(n_dev):
        local = owner[d] == d
        remap[d] = np.where(local, cols[d] - d * per, 0)
        for k in np.where(~local)[0]:
            remap[d, k] = recv_maps[d][int(cols[d, k])]
    return remap, deltas, tuple(s.shape[1] for s in sends), sends
