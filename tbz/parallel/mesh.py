"""Device mesh helpers.

The reference has no distribution layer (SURVEY §2.5); here a
jax.sharding.Mesh over the devices JAX reports, with data parallelism
over independent streams ('dp') and sequence parallelism over bytes of
one stream ('sp'). The mesh follows the algorithm alone: it assumes no
topology (NVLink joins the GPUs of one host all to all).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None) -> Mesh:
    """Mesh with ('dp','sp') axes. Defaults come from Config
    (mesh_dp/mesh_sp, settable via TBZ_MESH_DP/TBZ_MESH_SP); with no
    config either, all devices go on 'dp'."""
    from ..utils.config import get_config
    cfg = get_config()
    if sp is None:
        sp = cfg.mesh_sp or 1
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if dp is None:
        dp = cfg.mesh_dp if cfg.mesh_dp and cfg.mesh_dp * sp <= n else n // sp
    assert dp * sp <= n, (dp, sp, n)
    arr = np.array(devs[:dp * sp]).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def dp_spec(*trailing) -> P:
    return P("dp", *trailing)


__all__ = ["Mesh", "NamedSharding", "P", "make_mesh", "dp_spec"]
