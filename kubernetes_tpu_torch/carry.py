"""Carry a JAX scheduler's device state into the port.

This system's "weights" are its resident state: the node matrix a
`kubernetes_tpu` TPUScheduler keeps on its device (`_dev_nodes`, with the
folds of its uniform, scan and fused windows and of its pressure waves),
its two walk counters (last_index, last_node_index, which a pressure wave
moves too), its [profiles x priorities] weight table and the profile set
that maps a pod's schedulerName to a row. The victim table is not
carried: the port rebuilds it from the host snapshot at its first
preemption.
`state_from_jax` takes them as plain numpy and dicts (the caller reads them
off the JAX scheduler with `np.asarray` and `profile_dicts`) and returns
tensors a TorchScheduler adopts with `load_state`, so a window begun on
JAX can be finished on the port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.ops import resolve_device

#: field -> torch dtype of the resident node matrix
NODE_DTYPES = {
    "valid": torch.bool, "alloc_cpu": torch.int64, "alloc_mem": torch.int64,
    "alloc_eph": torch.int64, "allowed_pods": torch.int64,
    "req_cpu": torch.int64, "req_mem": torch.int64, "req_eph": torch.int64,
    "nz_cpu": torch.int64, "nz_mem": torch.int64, "pod_count": torch.int64,
    "alloc_scalar": torch.int64, "req_scalar": torch.int64,
    "zone_id": torch.int32,
}


def profile_dicts(profiles) -> list[dict]:
    """A profile set (either package's ProfileSet) as the dicts
    `ProfileSet.from_dict` reads back."""
    return [{"schedulerName": p.name, "priorities": dict(p.weights),
             "rankAwareGang": bool(p.rank_aware),
             "gangWeight": int(p.gang_weight)} for p in profiles]


def state_from_jax(arrays: dict[str, np.ndarray], last_index: int,
                   last_node_index: int, ptab: Optional[np.ndarray] = None,
                   device=None, profiles: Optional[list] = None) -> dict:
    """The port's form of a JAX scheduler's resident state: every node
    field as a tensor on `device` (cuda by default) with the port's dtype,
    the walk counters as ints, the weight table (or None) and the profile
    set as `profile_dicts` (or None)."""
    dev = resolve_device(device)
    missing = set(NODE_DTYPES) - set(arrays)
    if missing:
        raise ValueError(f"node matrix lacks fields {sorted(missing)}")
    n_pad = np.shape(arrays["valid"])[0]
    nodes = {}
    for k, dt in NODE_DTYPES.items():
        a = np.asarray(arrays[k])
        if a.shape[0] != n_pad:
            raise ValueError(f"{k} has {a.shape[0]} rows, valid has {n_pad}")
        nodes[k] = torch.from_numpy(np.array(a)).to(dev, dt)
    tab = None
    if ptab is not None:
        tab = torch.as_tensor(np.asarray(ptab, dtype=np.int64)).to(dev)
    return {"nodes": nodes, "last_index": int(last_index),
            "last_node_index": int(last_node_index), "ptab": tab,
            "profiles": None if profiles is None else list(profiles)}
