"""Crafted inputs for K2 broker_topk, shared by the CPU tests against the JAX
package (test_torch_kernels_cpu.py) and the card tests against the plain
version (test_torch_kernels_cuda.py). No JAX here: the card's machine has
none.

`case(name, full=False)` returns a dict of numpy inputs: `contrib` f32[P, R],
`assignment` i32[P, R], `movable` bool[P], `num_brokers`, `k` and
`heaviest`; `full` gives the card's sizes (the smoke model's 199,518
partitions where a case is about scale). "heavy_brokers" and "one_broker"
put brokers over BLOCK_PATH eligible slots at both sizes. `occurs(name, case, valid)` says
whether the case's point shows. Names: NAMES, and "k=<k>" for k in KS.
"""

from __future__ import annotations

import numpy as np

NAMES = ("all_equal", "signed_zeros", "no_eligible_broker", "k_above_count", "skewed_broker",
         "lightest", "leadership_masked", "dead_replica_runs", "bucketed_3072", "heavy_brokers",
         "one_broker")
#: a broker with more eligible slots than this is selected by its whole block
#: of the kernel's select, not by one warp (csrc/broker_topk.cu K2_HEAVY)
BLOCK_PATH = 2_048
#: the brokers "heavy_brokers" makes heavy: two in the first select block,
#: one in the next, the last broker
HEAVY = (0, 1, 2, 5, 8, 13, -1)
#: the k of the k sweep (a random case at each)
KS = (1, 8, 33)


def _assignment(rng, p, r, b, empty=0.05):
    a = rng.integers(0, b, (p, r)).astype(np.int32)
    a[rng.random((p, r)) < empty] = -1
    return a


def _eligible(c):
    a, mov = c["assignment"], c["movable"]
    ok = (a >= 0) & mov[:, None] & np.isfinite(c["contrib"])
    return np.bincount(a[ok], minlength=c["num_brokers"])


def _signed(rng, shape):
    return (rng.pareto(1.5, shape) * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


def case(name: str, full: bool = False) -> dict:
    rng = np.random.default_rng(NAMES.index(name) if name in NAMES else 100)
    p, r, b, k, heaviest = 600, 3, 24, 8, True
    if name == "all_equal":  # ties everywhere: the lowest flat index wins
        a = _assignment(rng, p, r, b)
        contrib = np.ones((p, r), np.float32)
    elif name == "signed_zeros":  # -0.0 ties +0.0, both directions
        a = _assignment(rng, p, r, b)
        contrib = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), (p, r))
    elif name == "no_eligible_broker":  # broker 5 all -inf, 6 all NaN, 7 holds nothing
        a = _assignment(rng, p, r, b)
        a[a == 7] = 8
        contrib = _signed(rng, (p, r))
        contrib[a == 5] = -np.inf
        contrib[a == 6] = np.nan
        contrib[rng.random((p, r)) < 0.05] = np.inf
    elif name == "k_above_count":  # k beyond most brokers' counts
        p, k = 100, 16
        a = _assignment(rng, p, r, b)
        contrib = _signed(rng, (p, r))
    elif name == "skewed_broker":  # broker 0 leads every partition: > 2,048 slots
        p = 20_000 if full else 2_500
        a = _assignment(rng, p, r, b, empty=0.0)
        a[:, 0] = 0
        contrib = _signed(rng, (p, r))
        k = 33
    elif name == "lightest":  # ascending order
        a = _assignment(rng, p, r, b)
        contrib = _signed(rng, (p, r))
        contrib[rng.random((p, r)) < 0.05] = -np.inf
        heaviest = False
    elif name == "leadership_masked":  # drain.py's leader weights: followers -inf
        a = _assignment(rng, p, r, b, empty=0.0)
        w = rng.pareto(1.5, p).astype(np.float32)
        rot = (0.5 + 0.5 * rng.random(p)).astype(np.float32)
        contrib = np.where(np.arange(r)[None, :] == 0, (w * rot)[:, None],
                           np.float32(-np.inf)).astype(np.float32)
        heaviest, k = False, 33
    elif name == "dead_replica_runs":  # the bulk planner's 1e9 on dead brokers' replicas
        a = _assignment(rng, p, r, b)
        contrib = rng.integers(0, 4, (p, r)).astype(np.float32)
        contrib[np.isin(a, [2, 9, 17])] = 1e9
    elif name == "bucketed_3072":  # 2,600 brokers padded to 3,072 empty ones
        p, b = (199_518 if full else 6_000), 3_072
        a = _assignment(rng, p, r, 2_600)
        contrib = _signed(rng, (p, r))
        contrib[rng.random((p, r)) < 0.3] = -np.inf
    elif name == "heavy_brokers":  # several brokers over BLOCK_PATH, ties among them
        p, k = (199_518 if full else 12_000), 20
        b = 2_600 if full else b
        a = _assignment(rng, p, r, b)
        a[:, 0] = np.array(HEAVY, np.int32)[rng.integers(0, len(HEAVY), p)] % b
        contrib = rng.integers(0, 40, (p, r)).astype(np.float32)
        contrib[rng.random((p, r)) < 0.05] = -np.inf
    elif name == "one_broker":  # every slot on broker 3, lightest first, signed zeros
        p = 199_518 if full else 1_000
        a = np.full((p, r), 3, np.int32)
        contrib = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, 2.0, np.nan], np.float32), (p, r))
        heaviest = False
    elif name.startswith("k="):  # the k sweep
        k = int(name[2:])
        a = _assignment(rng, p, r, b)
        contrib = _signed(rng, (p, r))
        contrib[rng.random((p, r)) < 0.05] = -np.inf
    else:
        raise KeyError(name)
    movable = rng.random(p) > 0.1
    if name == "skewed_broker":
        movable[:] = True
    out = {"contrib": np.ascontiguousarray(contrib, np.float32),
           "assignment": np.ascontiguousarray(a, np.int32), "movable": movable,
           "num_brokers": b, "k": k, "heaviest": heaviest}
    return out


def occurs(name: str, c: dict, valid: np.ndarray) -> bool:
    """Whether case `name`'s point shows in its inputs `c` and the
    reference's `valid` (bool[B, k])."""
    if name == "all_equal":
        return bool(valid.all())
    if name == "no_eligible_broker":
        return not valid[5].any() and not valid[6].any() and not valid[7].any()
    if name in ("k_above_count", "leadership_masked"):
        return 0 < int(valid.sum()) < valid.size
    if name == "skewed_broker":
        return int(_eligible(c)[0]) > 2_048
    if name == "dead_replica_runs":
        return bool(valid[[2, 9, 17]].all()) and int((c["contrib"] == 1e9).sum()) > 3 * c["k"]
    if name == "heavy_brokers":
        count = _eligible(c)
        hot = np.zeros(len(count), bool)
        hot[list(HEAVY)] = True
        return bool((count[hot] > BLOCK_PATH).all() and (count[~hot] <= BLOCK_PATH).all()
                    and valid[hot].all())
    if name == "one_broker":
        count = _eligible(c)
        return bool(count[3] > BLOCK_PATH and count.sum() == count[3] and valid[3].all())
    if name == "bucketed_3072":
        return not valid[2_600:].any() and bool(valid[:2_600, 0].any())
    if name == "signed_zeros":
        zeros = c["contrib"][c["contrib"] == 0]
        return bool(np.signbit(zeros).any() and (~np.signbit(zeros)).any())
    return bool(valid.any())
