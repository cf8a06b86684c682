"""Record sets for K12 shard_merge, shared by the CPU tests against the JAX
package's merge (test_torch_spmd.py: `jnp.lexsort((g_p, -g_score))`) and the
card tests against the plain version (test_torch_kernels_cuda.py). No JAX
here: the card's machine has none.

`records(kind, n_dev, k_loc, rng)` returns the [n_dev * k_loc] records a
mesh of n_dev shards gathers, k_loc a shard, as numpy arrays: scores f32[n]
and records i32[n, 4] (global partition, kind, slot, dst), shard d's
partitions sorted inside its block of ROWS rows. Kinds: KINDS.
"""

from __future__ import annotations

import numpy as np

KINDS = ("random", "ties across shards", "signed zeros", "all -inf", "some shards all -inf",
         "nan")
#: rows of a shard's block of the partition axis
ROWS = 4096
#: (shards, records a shard) of the sweeps; 8 x 640 records pass K12's
#: shared-memory staging and take several blocks
SHAPES = ((2, 1), (4, 1), (8, 1), (2, 16), (4, 16), (8, 16), (8, 640))


def records(kind: str, n_dev: int, k_loc: int, rng):
    n = n_dev * k_loc
    p = np.concatenate([np.sort(rng.choice(ROWS, k_loc, replace=False)) + ROWS * d
                        for d in range(n_dev)]).astype(np.int32)
    if kind == "random":
        s = rng.standard_normal(n).astype(np.float32)
    elif kind == "ties across shards":
        s = rng.choice(np.float32([1.5, 0.25, -2.0]), n).astype(np.float32)
    elif kind == "signed zeros":
        s = rng.choice(np.float32([0.0, -0.0, 1.0, -1.0]), n).astype(np.float32)
    elif kind == "all -inf":
        s = np.full(n, -np.inf, np.float32)
    elif kind == "some shards all -inf":
        s = rng.standard_normal(n).astype(np.float32)
        s[: (n_dev // 2) * k_loc] = -np.inf
    elif kind == "nan":
        s = rng.choice(np.float32([np.nan, 3.0, -np.inf, 3.0]), n).astype(np.float32)
    else:
        raise ValueError(kind)
    rest = rng.integers(-1, 1000, (n, 3)).astype(np.int32)
    return s, np.concatenate([p[:, None], rest], axis=1)
